"""The executor: run a program's global block eagerly on one device.

``Executor.run`` coerces the feeds, builds the environment from the scope's
state, the feeds and their ``@SEQ_LEN`` lengths, runs every op's lowering
in order, writes persistable outputs back to the scope (so running the
startup program initializes it) and returns the fetches.

Places: ``CUDAPlace(i)`` is a real CUDA device and the default; the CPU is
used only when the caller passes ``CPUPlace()``.  An executor asked for a
GPU that is not there raises instead of running on the CPU.

``passes=``, ``amp=`` and ``kernels=`` compose the program-rewrite
pipeline (``amp.compose_passes``) as in the JAX package.  ``kernels=None``
is resolved per device, as the JAX package resolves it per backend: the
kernel tier is on for a CUDA place, where the kernels run, and off on the
CPU.  The pipeline runs once per (program uid, version, feed names, fetch
names); the executor runs the rewritten program.  A program flagged by
``amp.enable_amp`` then goes through the ``amp-bf16`` pass (the legacy
bridge, memoized per program uid, version and fetch names), as in the JAX
package; one the pass cannot rewrite raises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .desc import BlockDesc, VarType
from .dtypes import coerce_feed_dtype, convert_dtype, to_numpy
from .framework import Program, Variable, default_main_program
from .lower import LowerCtx, lower_block
from .scope import Scope, global_scope
from .staging import FetchHandle

# scope var holding the executor's torch.Generator for random ops
RNG_STATE_VAR = "@RNG_STATE@"


class Place:
    """Device tag."""

    def __init__(self, kind: str, device_id: int = 0):
        self.kind = kind
        self.device_id = device_id

    def __repr__(self):
        return f"{self.kind.upper()}Place({self.device_id})"


def CPUPlace() -> Place:
    return Place("cpu", 0)


def CUDAPlace(device_id: int = 0) -> Place:
    return Place("cuda", device_id)


def place_device(place: Place) -> torch.device:
    """The torch device of ``place``; raises for a missing GPU."""
    if place.kind == "cpu":
        return torch.device("cpu")
    if place.kind != "cuda":
        raise ValueError(f"unknown place {place!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{place!r} requested but no CUDA device is available; pass "
            f"place=CPUPlace() to run on the CPU")
    if place.device_id >= torch.cuda.device_count():
        raise RuntimeError(f"{place!r} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) exist")
    return torch.device("cuda", place.device_id)


def analyze_state(block: BlockDesc, feed_names) -> tuple:
    """(state_in, state_out): names the block reads before any op writes
    them and that are not feeds, and written names that are persistable or
    read-modify-written."""
    defined = set(feed_names)
    state_in: List[str] = []
    written: List[str] = []
    for op in block.ops:
        for name in op.input_names():
            if name and name not in defined and name not in state_in:
                state_in.append(name)
        for name in op.output_names():
            if name:
                defined.add(name)
                if name not in written:
                    written.append(name)
    state_out = []
    for n in written:
        vd = block.find_var(n)
        if (vd is not None and vd.persistable) or n in state_in:
            state_out.append(n)
    return state_in, state_out


class Executor:
    """Eager executor on one device.  ``place=None`` means ``CUDAPlace(0)``.

    ``passes``: ``None``/``False``, a list of pass names or a
    ``PassPipeline``; ``amp``: ``None``/``AmpPolicy``/``AmpConfig``;
    ``kernels``: ``None`` (on for a CUDA place, off on the CPU),
    ``True``/``False`` or a ``KernelPolicy``."""

    def __init__(self, place: Optional[Place] = None, passes=None, amp=None,
                 kernels=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = place_device(self.place)
        from ..ops.cuda.policy import as_kernel_policy
        if kernels is None:
            kernels = self.device.type == "cuda"
        self.kernel_policy = as_kernel_policy(kernels)
        if passes or amp or self.kernel_policy is not None:
            from ..amp import compose_passes
            self.passes = compose_passes(passes, amp, kernels=self.kernel_policy)
        else:
            self.passes = None
        # (uid, version, amp flag, feed names, fetch names) -> the program to run
        self._pass_memo: Dict[tuple, Program] = {}
        # (uid, version, fetch names) -> the amp-bf16 rewrite of a program
        # flagged by enable_amp
        self._amp_bridge_memo: Dict[tuple, Program] = {}

    def _apply_passes(self, program: Program, feed_names: List[str],
                      fetch_names: List[str]) -> Program:
        """The rewritten program, from the pipeline run once per (program
        uid, version, amp flag, feed names, fetch names).  The rewrite lands
        on a clone with the program's uid and a version of its own, so
        running the rewritten program again hits the memo too.  A program
        flagged by ``enable_amp`` goes through the bridge after the pipeline
        (the flag is in the key: setting it does not move the version)."""
        if self.passes is None:
            return self._legacy_amp_rewrite(program, fetch_names)
        names = (tuple(sorted(feed_names)), tuple(fetch_names))
        key = (program.desc.uid, program.desc.version, program.amp) + names
        hit = self._pass_memo.get(key)
        if hit is not None:
            return hit
        new_prog, _ = self.passes.run(program, fetch_list=fetch_names,
                                      feed_names=feed_names)
        new_prog = self._legacy_amp_rewrite(new_prog, fetch_names)
        self._pass_memo[key] = new_prog
        self._pass_memo[(new_prog.desc.uid, new_prog.desc.version, new_prog.amp) + names] = \
            new_prog
        return new_prog

    def _legacy_amp_rewrite(self, program: Program,
                            fetch_names: List[str]) -> Program:
        """The ``program.amp = True`` bridge: the flag goes through the
        ``amp-bf16`` pass with the default policy, so the legacy API is
        fingerprint-identical to the pass path.  A program an amp pass has
        already rewritten is left alone.  The JAX package runs a program
        the pass skips (several blocks) with lowering-time casts; the port
        has no such path, and running it in float32 would ignore the
        flag, so it raises."""
        if not program.amp or program._amp_policy_fp:
            return program
        key = (program.desc.uid, program.desc.version, tuple(fetch_names))
        hit = self._amp_bridge_memo.get(key)
        if hit is not None:
            return hit
        from ..passes import PassPipeline
        new_prog, result = PassPipeline(["amp-bf16"], verify="off").run(
            program, fetch_list=fetch_names)
        skipped = result.passes[0].skipped
        if skipped:
            raise NotImplementedError(
                f"program.amp is set but the amp-bf16 pass skips this program "
                f"({skipped}); the port has no lowering-time cast path to run "
                f"it in bf16 -- call amp.disable_amp(program) to run it in float32")
        self._amp_bridge_memo[key] = new_prog
        if new_prog is not program:
            self._amp_bridge_memo[(new_prog.desc.uid, new_prog.desc.version)
                                  + key[2:]] = new_prog
        return new_prog

    def _feed_to_tensor(self, block: BlockDesc, name: str, value) -> torch.Tensor:
        """A feed as a tensor on this executor's device, in its declared
        dtype (the value's own for undeclared ``@SEQ_LEN`` feeds), with
        64-bit types narrowed."""
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        vd = block.find_var(name)
        want = vd.dtype if vd is not None and vd.type == VarType.DENSE_TENSOR \
            else convert_dtype(t.dtype)
        return t.to(device=self.device, dtype=coerce_feed_dtype(want).torch_dtype)

    def run(self, program: Optional[Program] = None, feed: Optional[dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True, sync: bool = True):
        """Run block 0 once.  ``sync=False`` returns :class:`FetchHandle`\\ s
        that materialize on first read, so the caller can enqueue the next
        step meanwhile; otherwise numpy arrays (``return_numpy``; a bf16 value
        comes back as float32, numpy having no bfloat16) or the
        device tensors."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        program = self._apply_passes(program, list(feed), fetch_names)
        block = program.desc.block(0)

        env: Dict[str, Any] = {}
        state_in, state_out = analyze_state(block, feed)
        for n in state_in:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"variable {n!r} used by the program is not initialized "
                    f"in the scope -- run the startup program first")
            env[n] = v
        for k, v in feed.items():
            env[k] = self._feed_to_tensor(block, k, v)

        gen = scope.find_var(RNG_STATE_VAR)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(program.random_seed or 0)
            scope.set_var(RNG_STATE_VAR, gen)

        ctx = LowerCtx(block, env, gen, self.device)
        with torch.no_grad():
            lower_block(ctx, block)
        for n in state_out:
            if n in env:
                scope.update_var(n, env[n])
        fetches = [ctx.read(n) for n in fetch_names]

        if not sync:
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            return [FetchHandle(v, event) for v in fetches]
        if return_numpy:
            return [to_numpy(v) for v in fetches]
        return fetches
