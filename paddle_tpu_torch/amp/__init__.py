"""bf16 mixed precision and int8 quantization as program rewrites.

The port of the JAX package's ``paddle_tpu.amp``: :class:`AmpPolicy` (per
op-type dtype rules), :class:`AmpConfig` (the ``amp=`` knob of
``Executor``/``Inferencer``/``ServingSession``) and :func:`compose_passes`,
which builds the executor's pass pipeline from the ``passes=``, ``amp=``
and ``kernels=`` knobs:

* ``amp-bf16`` -- bf16 compute with float32 master weights and optimizer
  state, bf16 gradients promoted at the update (``AmpConfig()``);
* ``amp-quant-int8`` -- the simulated-int8 serving path that the kernel
  tier turns into real int8 GEMMs (``AmpConfig(bf16=False, quant=True)``).

The legacy API flags a program for the ``amp-bf16`` pass; the executor
rewrites it on first run, after its own pipeline (the JAX package's
order: kernel tier first, then the bridge).  A program the pass cannot
rewrite (several blocks) raises there instead of running in float32.

Usage::

    exe = Executor(CUDAPlace(0), amp=AmpConfig())
    amp.enable_amp(main_program)        # or: the legacy flag, before run
    with amp.amp_guard(main_program):
        exe.run(...)
    session = ServingSession(infer_func,
                             amp=AmpConfig(bf16=False, quant=True),
                             kernels=True)
"""
from __future__ import annotations

import contextlib

from .policy import BLACKLIST, WHITELIST, AmpConfig, AmpPolicy

__all__ = ["AmpConfig", "AmpPolicy", "as_amp_config", "compose_passes",
           "enable_amp", "disable_amp", "amp_guard", "white_list", "black_list"]


def as_amp_config(amp):
    """Normalize the ``amp=`` knob: ``None``/``False`` → no amp,
    ``True`` → default :class:`AmpConfig`, a policy → a bf16 config over
    it, a config → itself."""
    if amp is None or amp is False:
        return None
    if amp is True:
        return AmpConfig()
    if isinstance(amp, AmpPolicy):
        return AmpConfig(policy=amp)
    if isinstance(amp, AmpConfig):
        return amp
    raise TypeError(f"amp= accepts None/bool/AmpPolicy/AmpConfig, "
                    f"got {type(amp).__name__}")


def compose_passes(passes, amp, kernels=None):
    """One executor pipeline from the ``passes=``, ``amp=`` and
    ``kernels=`` knobs, in the JAX package's order: the amp passes slot in
    before the liveness passes (``dead-op-elim`` sweeps orphaned
    declarations, ``donation-insert`` sees the final program):
    ``amp-quant-int8`` (it claims the policy-selected float32 matmuls
    before the bf16 rewrite would narrow them), ``amp-bf16``, then
    ``pallas-kernels`` (which consumes the quant pass's simulated groups
    and must see the post-amp op set).  ``kernels`` is a resolved
    :class:`~paddle_tpu_torch.ops.cuda.policy.KernelPolicy` or ``None``.
    Returns a ``PassPipeline`` (with the ``verify`` mode of ``passes=``'s
    pipeline, else ``"error"``) or ``None``."""
    from ..ops.cuda.kernel_pass import PallasKernelsPass
    from ..passes import PassPipeline, make_pipeline
    from .passes import AmpBf16Pass, QuantInt8Pass
    cfg = as_amp_config(amp)
    base = make_pipeline(passes)
    if cfg is None and kernels is None:
        return base
    extra = []
    if cfg is not None and cfg.quant:
        extra.append(QuantInt8Pass(cfg.policy, bits=cfg.quant_bits,
                                   quant_ops=cfg.quant_ops))
    if cfg is not None and cfg.bf16:
        extra.append(AmpBf16Pass(cfg.policy))
    if kernels is not None:
        extra.append(PallasKernelsPass(kernels))
    if base is None:
        return PassPipeline(extra)
    insts = list(base.passes)
    idx = next((k for k, p in enumerate(insts)
                if p.name in ("dead-op-elim", "donation-insert")), len(insts))
    return PassPipeline(insts[:idx] + extra + insts[idx:], verify=base.verify)


# --------------------------------------------------------------- legacy API

def enable_amp(program=None):
    """Flag ``program`` (default: the main program) for the ``amp-bf16``
    pass with the default policy: the executor rewrites it on first run,
    fingerprint-identical to ``PassPipeline(["amp-bf16"])``.  Prefer
    ``Executor(amp=AmpConfig(...))``."""
    from ..core.framework import default_main_program
    program = program or default_main_program()
    program.amp = True
    return program


def disable_amp(program=None):
    from ..core.framework import default_main_program
    program = program or default_main_program()
    program.amp = False
    return program


@contextlib.contextmanager
def amp_guard(program=None, enable: bool = True):
    """Set ``program.amp`` to ``enable`` inside the block, then restore it."""
    from ..core.framework import default_main_program
    program = program or default_main_program()
    prev = program.amp
    program.amp = bool(enable)
    try:
        yield program
    finally:
        program.amp = prev


def white_list():
    return set(WHITELIST)


def black_list():
    return set(BLACKLIST)
