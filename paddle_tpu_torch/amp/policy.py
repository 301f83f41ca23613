"""AmpPolicy: per-op dtype rules for the mixed-precision passes.

A copy of the JAX package's ``paddle_tpu/amp/policy.py`` (stdlib-only; the
port never imports that package), with the same tables and rules, so an
``AmpPolicy`` or ``AmpConfig`` fingerprints equally in both packages for
equal arguments.  The rules are first-match (regex, dtype-class) rows
over **op types**:

* ``bf16`` class (whitelist): compute-bound matmul/conv/rnn ops;
* ``fp32`` class (blacklist): numerically sensitive ops -- softmax,
  losses, reductions and norm statistics;
* ``passthrough`` (everything else).

Grad ops inherit their forward op's class.  The policy drives the
``amp-bf16`` training rewrite and selects the matmuls the
``amp-quant-int8`` pass quantizes.
"""
from __future__ import annotations

import hashlib
import json
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["AmpPolicy", "AmpConfig", "WHITELIST", "BLACKLIST",
           "GRAD_UNCAST", "FP32_OUT", "KEEP_OPS"]

#: bf16 class — compute-bound op types (tensor cores under bf16).
WHITELIST = frozenset({
    "mul", "matmul", "fc", "conv2d", "conv2d_transpose", "depthwise_conv2d",
    "conv3d", "sequence_conv", "bilinear_tensor_product", "flash_attention",
    "dynamic_lstm", "dynamic_gru", "lstm", "gru",
    # matmul-dominated fused loss head: its softmax/LSE math is fp32
    # internally (ops/fused_ce.py) whatever its operands' dtype
    "fused_fc_softmax_ce",
})

#: fp32 class — numerically sensitive op types (softmax/losses/norm
#: statistics; batch_norm's running statistics drift when accumulated in
#: bf16).
BLACKLIST = frozenset({
    "softmax", "softmax_with_cross_entropy", "cross_entropy", "cross_entropy2",
    "sigmoid_cross_entropy_with_logits", "mean", "sum", "reduce_sum",
    "reduce_mean", "reduce_prod", "exp", "log", "sqrt", "rsqrt", "square",
    "squared_l2_norm", "squared_l2_distance", "layer_norm", "softmax_grad",
    "cos_sim", "cumsum", "linear_chain_crf", "nce", "hsigmoid", "warpctc",
    "batch_norm",
})

#: grad ops that must NOT have their inputs cast even though the forward
#: op is classified: the op body manages its own operand precision.
GRAD_UNCAST = frozenset({"fused_fc_softmax_ce_grad"})

#: whitelist ops whose OUTPUTS are intrinsically fp32 whatever the
#: compute dtype (fp32 accumulation inside the kernel): the bf16 pass
#: casts their inputs but never retypes their outputs — the declared
#: fp32 matches the runtime, per their InferShape rules.
FP32_OUT = frozenset({"fused_fc_softmax_ce"})

#: op types the bf16 pass never rewrites: their output dtype is an
#: explicit attribute / sampling contract, not an input-propagation fact,
#: so flipping declared dtypes or casting inputs would change semantics.
KEEP_OPS = frozenset({
    "cast", "fill_constant", "fill_constant_batch_size_like", "fill_zeros_like",
    "assign", "shape", "lod_reset", "one_hot", "uniform_random",
    "gaussian_random", "range", "increment", "cum_op", "lookup_table",
    "fake_quantize_abs_max", "fake_quantize_range_abs_max",
    "fake_dequantize_max_abs", "fake_quantize_ste_grad",
    "feed", "fetch", "read",
})


def _alt(names: Iterable[str]) -> str:
    """Anchored alternation over literal op types — the DEFAULT_RULES are
    plain (pattern, class) rows, so user rules compose with (and pre-empt)
    them by position."""
    return r"^(?:" + "|".join(sorted(re.escape(n) for n in names)) + r")$"


class AmpPolicy:
    """First-match (regex, dtype-class) rules over op types.

    ``rules`` rows are ``(pattern, cls)`` with ``cls`` in ``("bf16",
    "fp32", "passthrough")``; user rows are consulted before
    :data:`DEFAULT_RULES` (whitelist/blacklist tables), so
    ``AmpPolicy(rules=[("conv2d", "fp32")])`` demotes convs without
    touching anything else.  Grad ops with no direct match inherit the
    forward type's class.  ``fingerprint()`` is the stable content hash
    keyed into the pass-pipeline fingerprint.
    """

    CLASSES = ("bf16", "fp32", "passthrough")

    DEFAULT_RULES: Tuple[Tuple[str, str], ...] = (
        (_alt(WHITELIST), "bf16"),
        (_alt(BLACKLIST), "fp32"),
    )

    def __init__(self, rules: Optional[Sequence[Tuple[str, str]]] = None):
        user = []
        for pat, cls in (rules or ()):
            if cls not in self.CLASSES:
                raise ValueError(
                    f"amp rule {pat!r}: class must be one of "
                    f"{self.CLASSES}, got {cls!r}")
            re.compile(pat)  # fail fast on a bad pattern
            user.append((str(pat), str(cls)))
        self.rules: Tuple[Tuple[str, str], ...] = \
            tuple(user) + self.DEFAULT_RULES
        self._memo: Dict[str, str] = {}

    def class_for(self, op_type: str) -> str:
        """The dtype class for ``op_type`` — first matching rule wins;
        ``*_grad`` ops with no direct match inherit the forward class;
        unmatched ops are ``"passthrough"``."""
        hit = self._memo.get(op_type)
        if hit is not None:
            return hit
        cls = self._match(op_type)
        if cls is None and op_type.endswith("_grad"):
            cls = ("passthrough" if op_type in GRAD_UNCAST
                   else self._match(op_type[:-len("_grad")]))
        cls = cls or "passthrough"
        self._memo[op_type] = cls
        return cls

    def _match(self, op_type: str) -> Optional[str]:
        for pat, cls in self.rules:
            if re.search(pat, op_type):
                return cls
        return None

    def fingerprint(self) -> str:
        """Stable content hash of the ordered rules (the semantic policy
        payload — memoization state excluded)."""
        payload = json.dumps({"rules": [list(r) for r in self.rules]},
                             sort_keys=True)
        return hashlib.sha1(payload.encode()).hexdigest()

    def __repr__(self):
        n_user = len(self.rules) - len(self.DEFAULT_RULES)
        return (f"AmpPolicy({n_user} custom rule(s), "
                f"fp={self.fingerprint()[:12]})")


class AmpConfig:
    """The user-facing mixed-precision knob for ``Executor(amp=)`` /
    ``Inferencer(amp=)`` / ``ServingSession(amp=)``.

    * ``bf16`` (default on): the ``amp-bf16`` training pass, which is not
      ported yet (``compose_passes`` raises ``NotImplementedError``).
    * ``quant``: apply the ``amp-quant-int8`` serving pass — wrap
      policy-selected matmuls in ``fake_quantize_abs_max`` /
      ``fake_dequantize_max_abs`` for the simulated-int8 calibrated
      inference path (inference programs only).
    * ``custom_white_list`` / ``custom_black_list``: extra op types
      prepended to the default policy as anchored rules.
    * ``policy``: a full :class:`AmpPolicy` override (the custom lists
      are then ignored).
    """

    def __init__(self, policy: Optional[AmpPolicy] = None,
                 custom_white_list: Iterable[str] = (),
                 custom_black_list: Iterable[str] = (),
                 bf16: bool = True, quant: bool = False,
                 quant_bits: int = 8,
                 quant_ops: Sequence[str] = ("mul", "matmul")):
        if policy is not None and (list(custom_white_list)
                                   or list(custom_black_list)):
            raise ValueError("pass either a full policy= or the "
                             "custom_*_list knobs, not both")
        if policy is None:
            rules = []
            if custom_white_list:
                rules.append((_alt(custom_white_list), "bf16"))
            if custom_black_list:
                rules.append((_alt(custom_black_list), "fp32"))
            policy = AmpPolicy(rules=rules)
        self.policy = policy
        self.bf16 = bool(bf16)
        self.quant = bool(quant)
        self.quant_bits = int(quant_bits)
        self.quant_ops = tuple(sorted(quant_ops))
        if not 2 <= self.quant_bits <= 16:
            raise ValueError(f"quant_bits must be in [2,16], "
                             f"got {quant_bits}")
        if not (self.bf16 or self.quant):
            raise ValueError("AmpConfig with bf16=False and quant=False "
                             "configures nothing; pass amp=None instead")

    def fingerprint(self) -> str:
        payload = json.dumps({
            "policy": self.policy.fingerprint(), "bf16": self.bf16,
            "quant": self.quant, "quant_bits": self.quant_bits,
            "quant_ops": list(self.quant_ops)}, sort_keys=True)
        return hashlib.sha1(payload.encode()).hexdigest()

    def __repr__(self):
        modes = [m for m, on in (("bf16", self.bf16),
                                 (f"int{self.quant_bits}", self.quant)) if on]
        return f"AmpConfig({'+'.join(modes)}, fp={self.fingerprint()[:12]})"
