"""Mixed precision and int8 quantization as program rewrites.

The port of the JAX package's ``paddle_tpu.amp``: :class:`AmpPolicy` (per
op-type dtype rules), :class:`AmpConfig` (the ``amp=`` knob of
``Executor``/``Inferencer``/``ServingSession``) and :func:`compose_passes`,
which builds the executor's pass pipeline from the ``passes=``, ``amp=``
and ``kernels=`` knobs.  Ported: the ``amp-quant-int8`` serving pass
(``AmpConfig(bf16=False, quant=True)``), the simulated-int8 path that the
kernel tier turns into real int8 GEMMs.  Not ported yet: the ``amp-bf16``
training pass (``AmpConfig(bf16=True)`` raises) and the legacy
``enable_amp``/``amp_guard`` bridge.

Usage::

    session = ServingSession(infer_func,
                             amp=AmpConfig(bf16=False, quant=True),
                             kernels=True)
"""
from __future__ import annotations

from .policy import AmpConfig, AmpPolicy

__all__ = ["AmpConfig", "AmpPolicy", "as_amp_config", "compose_passes"]


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
    ``kernels=`` knobs, in the JAX package's order: the user's passes,
    then ``amp-quant-int8``, then ``pallas-kernels`` (which consumes the
    quant pass's simulated groups and must see the post-amp op set).
    ``kernels`` is a resolved
    :class:`~paddle_tpu_torch.ops.cuda.policy.KernelPolicy` or ``None``.
    Returns a ``PassPipeline`` (``verify="off"``) or ``None``."""
    from ..ops.cuda.kernel_pass import PallasKernelsPass
    from ..passes import PassPipeline, make_pipeline
    from .passes import QuantInt8Pass
    cfg = as_amp_config(amp)
    if cfg is not None and cfg.bf16:
        raise NotImplementedError(
            "AmpConfig(bf16=True): the amp-bf16 pass is not ported yet (it "
            "comes with the bf16 training slice); use AmpConfig(bf16=False, "
            "quant=True) for int8 serving")
    base = make_pipeline(passes)
    if cfg is None and kernels is None:
        return base
    extra = []
    if cfg is not None and cfg.quant:
        extra.append(QuantInt8Pass(cfg.policy, bits=cfg.quant_bits,
                                   quant_ops=cfg.quant_ops))
    if kernels is not None:
        extra.append(PallasKernelsPass(kernels))
    insts = list(base.passes) if base is not None else []
    return PassPipeline(insts + extra, verify="off")
