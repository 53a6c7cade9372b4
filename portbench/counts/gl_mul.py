"""Op group "gl_mul": Goldilocks products by plonky2_tpu_torch/ops/gf.mul
(-> csrc/field.cu), outside the other groups' calls.

Least work of a call: one product a word of the broadcast result, each
operand word read once (a Python int constant is one word) and each
result word written once."""

from __future__ import annotations

from ._bounds import OPS_PER_FIELD_PRODUCT

TARGETS = [("plonky2_tpu_torch.ops.gf", "mul")]


def work(name, args, kwargs, out):
    a, b = args[0], args[1] if len(args) > 1 else kwargs["b"]
    if not getattr(a, "is_cuda", False):
        return None
    b_words = b.numel() if hasattr(b, "numel") else 1
    return a.numel() + b_words + out.numel(), out.numel() * OPS_PER_FIELD_PRODUCT
