"""Base encoding on device — the device twin of the reference's bitEncode kernel.

The reference encodes one read per CUDA thread, walking chars serially and
packing 2-bit codes into uint64 words in place (GPUHandler.cu:10-111).  Here
the natural shape is the whole chunk at once: a dense ``[R, L]`` uint8
ASCII matrix is mapped elementwise to 2-bit codes plus a validity mask.  Packing into key words is deferred to extraction (ops.extract), which
builds the per-window uint32 lanes directly from codes — this fuses the
reference's two kernels into one XLA-fused elementwise program and avoids
materializing packed reads at all.

Alphabet (GPUHandler.cu:42-78): A=0, C=1, G=2, T=3; any other character
encodes as 3 with its validity bit cleared (GPUHandler.cu:79-87).  Unlike
the reference we accept lower-case bases.
"""

from __future__ import annotations

import jax.numpy as jnp


def encode_reads(reads: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """ASCII reads ``[R, L] uint8`` → (codes ``[R, L] uint32``, valid ``[R, L] bool``).

    Pure elementwise compare/select chain — no gather — so XLA fuses it into
    whatever consumes the codes.
    """
    c = reads.astype(jnp.uint8)
    upper = jnp.where((c >= ord("a")) & (c <= ord("z")), c - 32, c)
    is_a = upper == ord("A")
    is_c = upper == ord("C")
    is_g = upper == ord("G")
    is_t = upper == ord("T")
    valid = is_a | is_c | is_g | is_t
    codes = (
        jnp.where(is_c, jnp.uint32(1), jnp.uint32(0))
        | jnp.where(is_g, jnp.uint32(2), jnp.uint32(0))
        | jnp.where(is_t | ~valid, jnp.uint32(3), jnp.uint32(0))
    )
    return codes, valid
