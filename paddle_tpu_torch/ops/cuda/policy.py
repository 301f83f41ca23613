"""KernelPolicy: which ops the ``pallas-kernels`` pass rewrites onto the
hand-written Hopper kernels, and when a kernel is worth it.

The port of the JAX package's ``paddle_tpu/ops/pallas/policy.py``, with the
same knobs, the same rules and the same fingerprint payload, so a policy
built from equal arguments fingerprints equally in both packages (and the
pass writes equal ProgramDescs).  The pass keeps the JAX package's name and
op types (``pallas-kernels``, ``pallas_int8_matmul``, ``pallas_sgd``,
``pallas_adam``, ``pallas_gather``, ``pallas_scatter_add``): they are part
of the ProgramDesc.

The default knob values describe the card's kernels, not the TPU's:

* ``flash_lane = 16``: K1 (csrc/flash_attention_fwd.cu) takes head_dim
  16, 32, 64 and 128, multiples of 16; the TPU's 128-lane rule would
  decline transformer-base's head_dim 64 and drop K1 from its path.
  ``flash_profitable`` also declines a head_dim K1 does not take.
* ``flash_block_q = flash_block_k = 64``: K1's query tile and its key tile
  at head_dim <= 64.
* ``flash_min_block_q = 1``: K1 masks a ragged query tile itself, so no
  sequence length is too short, and the decision needs no static T (the
  pass stamps ops whose T is only known at run time).
* ``embedding_vmem_bytes = 80 GiB``: K2 and K3 stream rows from device
  memory and keep no table on chip, so any table the card holds is
  admitted (the name is the JAX package's knob, kept for the fingerprint).
* ``optimizer_min_numel = 4096``, as in the JAX package.  In the port the
  un-retyped ``sgd``/``adam`` of a smaller parameter go to the same
  multi-tensor K5/K6 launch on a CUDA tensor, so this decides the op type
  and, for Adam, the expression its entry computes: ``adam`` the composed
  ``((1 - b2) * g) * g``, ``pallas_adam`` ``(1 - b2) * (g * g)``, each
  with its own roundings, as in the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import re
from typing import Dict, Optional, Sequence, Tuple

from ...amp.policy import _alt
from .flash_attention import HEAD_DIMS

__all__ = ["KERNELS", "KernelPolicy", "as_kernel_policy", "DEFAULT_POLICY"]

#: the four kernel families
KERNEL_FLASH = "flash_attention"
KERNEL_INT8 = "int8_matmul"
KERNEL_OPT = "fused_optimizer"
KERNEL_EMB = "embedding"
KERNELS = (KERNEL_FLASH, KERNEL_INT8, KERNEL_OPT, KERNEL_EMB)

#: op type -> kernel family; ``*_grad`` ops inherit their forward op's
#: family.  mul/matmul map to the int8 kernel, but the pass only rewrites
#: the instances the ``amp-quant-int8`` pass already claimed.
DEFAULT_RULES: Tuple[Tuple[str, str], ...] = (
    (_alt(["flash_attention"]), KERNEL_FLASH),
    (_alt(["mul", "matmul"]), KERNEL_INT8),
    (_alt(["sgd", "adam"]), KERNEL_OPT),
    (_alt(["lookup_table"]), KERNEL_EMB),
)

_GRAD_SUFFIX = "_grad"


def _pick_block(t: int, target: int) -> int:
    """Largest halving of ``target`` that divides ``t``."""
    b = min(t, target)
    while t % b:
        b //= 2
    return max(b, 1)


class KernelPolicy:
    """Which ops lower onto the hand-written kernels, and when.

    ``rules`` prepend ``DEFAULT_RULES`` (first match wins); ``disable``
    removes whole kernel families by name.  The shape knobs are the
    thresholds the predicates check (module docstring)."""

    def __init__(self, rules: Optional[Sequence[Tuple[str, str]]] = None,
                 disable: Sequence[str] = (),
                 flash_block_q: int = 64, flash_block_k: int = 64,
                 flash_min_block_q: int = 1, flash_lane: int = 16,
                 embedding_vmem_bytes: int = 80 << 30,
                 optimizer_min_numel: int = 4096):
        self.rules: Tuple[Tuple[str, str], ...] = (
            tuple((p, k) for p, k in (rules or ())) + DEFAULT_RULES)
        unknown = set(disable) - set(KERNELS)
        if unknown:
            raise ValueError(f"disable= names unknown kernels {sorted(unknown)}; "
                             f"registered: {list(KERNELS)}")
        self.disable = tuple(sorted(set(disable)))
        self.flash_block_q = int(flash_block_q)
        self.flash_block_k = int(flash_block_k)
        self.flash_min_block_q = int(flash_min_block_q)
        self.flash_lane = int(flash_lane)
        self.embedding_vmem_bytes = int(embedding_vmem_bytes)
        self.optimizer_min_numel = int(optimizer_min_numel)
        self._compiled = tuple((re.compile(p), k) for p, k in self.rules)
        self._memo: Dict[str, Optional[str]] = {}

    def kernel_for(self, op_type: str) -> Optional[str]:
        """First-match kernel family for ``op_type`` (or None)."""
        hit = self._memo.get(op_type, "")
        if hit != "":
            return hit
        kernel = None
        for rx, k in self._compiled:
            if rx.match(op_type):
                kernel = k
                break
        if kernel is None and op_type.endswith(_GRAD_SUFFIX):
            kernel = self.kernel_for(op_type[:-len(_GRAD_SUFFIX)])
        if kernel in self.disable:
            kernel = None
        self._memo[op_type] = kernel
        return kernel

    @property
    def flash_needs_seq_len(self) -> bool:
        """Whether the flash decision depends on T (a query-tile floor):
        without one it is made from the head dim alone."""
        return self.flash_min_block_q > 1

    def flash_profitable(self, tq: int, tk: int, head_dim: int,
                         block_q: Optional[int] = None,
                         block_k: Optional[int] = None
                         ) -> Tuple[bool, Optional[str]]:
        """Is K1 worth launching for this geometry?  ``(ok, reason)``."""
        if head_dim <= 0:
            return False, "dynamic-shape"
        if head_dim % self.flash_lane:
            return False, "head-dim-unaligned"
        if head_dim not in HEAD_DIMS:
            return False, "head-dim-unsupported"
        if self.flash_needs_seq_len:
            if tq <= 0 or tk <= 0:
                return False, "dynamic-shape"
            if _pick_block(tq, block_q or self.flash_block_q) < self.flash_min_block_q:
                return False, "q-tile-too-small"
        return True, None

    def embedding_profitable(self, rows: int, width: int, itemsize: int = 4
                             ) -> Tuple[bool, Optional[str]]:
        if rows <= 0 or width <= 0:
            return False, "dynamic-shape"
        if rows * width * itemsize > self.embedding_vmem_bytes:
            return False, "table-exceeds-budget"
        return True, None

    def optimizer_profitable(self, numel: int) -> Tuple[bool, Optional[str]]:
        if numel <= 0:
            return False, "dynamic-shape"
        if numel < self.optimizer_min_numel:
            return False, "param-too-small"
        return True, None

    def fingerprint(self) -> str:
        payload = {
            "rules": [list(r) for r in self.rules],
            "disable": list(self.disable),
            "flash": [self.flash_block_q, self.flash_block_k,
                      self.flash_min_block_q, self.flash_lane],
            "embedding_vmem_bytes": self.embedding_vmem_bytes,
            "optimizer_min_numel": self.optimizer_min_numel,
        }
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()

    def __repr__(self) -> str:
        return (f"KernelPolicy(rules={len(self.rules)}, "
                f"disable={list(self.disable)}, "
                f"fp={self.fingerprint()[:12]})")


def as_kernel_policy(kernels) -> Optional[KernelPolicy]:
    """Normalize the ``kernels=`` knob: ``None``/``False`` → no kernel
    tier, ``True`` → default :class:`KernelPolicy`, a policy → itself.
    (The executor resolves ``None`` per device before calling this.)"""
    if kernels is None or kernels is False:
        return None
    if kernels is True:
        return KernelPolicy()
    if isinstance(kernels, KernelPolicy):
        return kernels
    raise TypeError(f"kernels= accepts None/bool/KernelPolicy, "
                    f"got {type(kernels).__name__}")


DEFAULT_POLICY = KernelPolicy()
