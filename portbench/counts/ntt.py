"""Op group "ntt": the transforms of plonky2_tpu_torch/ops/ntt.py, whatever
kernels carry them (csrc/ntt.cu's column and row passes, the product
kernel, PyTorch glue).

Least work of a call from its shapes: every word in and out once, and the
butterflies of the transform, (N/2) log2 N products for each of its
polynomials. The scalings by the coset shift or by 1/N are left out (they
fold into the twiddles). An LDE onto the coset of 2^r N points is 2^r
transforms of N points: the first r stages over zero-padded coefficients
only copy."""

from __future__ import annotations

from ._bounds import OPS_PER_FIELD_PRODUCT

TARGETS = [
    ("plonky2_tpu_torch.ops.ntt", "fft"),
    ("plonky2_tpu_torch.ops.ntt", "ifft"),
    ("plonky2_tpu_torch.ops.ntt", "coset_fft"),
    ("plonky2_tpu_torch.ops.ntt", "coset_ifft"),
    ("plonky2_tpu_torch.ops.ntt", "lde_onto_coset"),
]


def work(name, args, kwargs, out):
    """(words moved, integer operations) of one call, None off the card."""
    x = args[0]
    if not getattr(x, "is_cuda", False):
        return None
    n = x.shape[-1]
    polys = x.numel() // n
    n_log = n.bit_length() - 1
    size_out = out.numel()
    if name == "lde_onto_coset":
        rate_bits = args[1] if len(args) > 1 else kwargs["rate_bits"]
        products = polys * (1 << rate_bits) * (n // 2) * n_log
    else:
        products = polys * (n // 2) * n_log
    return x.numel() + size_out, products * OPS_PER_FIELD_PRODUCT
