"""Systematic transformations of MC sample fields.

Vectorized re-design of the reference ``apply_systematic`` device function
(reference: src/pdfz.cpp:306-331).  Instead of a per-sample scalar loop the
transforms are pure vectorized functions of a whole ``(nsamples, nfields)``
array, composed in order.  The per-systematic shift ``p`` is a power series
in the (current) value of the affected observable,

    p = sum_i  theta[par_index[i]] * x**i

exactly as in the reference (pdfz.cpp:310-314), where ``theta`` is the
global systematic-parameter vector.

Transform types (pdfz.h:109-233):
    SHIFT:            x' = x + p
    SCALE:            x' = x * (1 + p)
    CTSCALE:          x' = 1 + (x - 1) * (1 + p)
    RESOLUTION_SCALE: x' = x + p * (x - x_true)

Systematics are applied *sequentially*: a later systematic sees the field
values produced by earlier ones, matching the in-place field_buffer update
of the reference kernel (pdfz.cpp:382-385).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax.numpy as jnp

SHIFT = 0
SCALE = 1
RESOLUTION_SCALE = 2
CTSCALE = 3

_TYPE_NAMES = {
    "shift": SHIFT,
    "scale": SCALE,
    "resolution_scale": RESOLUTION_SCALE,
    "ctscale": CTSCALE,
}


def systematic_type_from_name(name: str) -> int:
    """Map the JSON DSL type string to a type id (systematic.cpp:21-39)."""
    try:
        return _TYPE_NAMES[name]
    except KeyError:
        raise ValueError(f"Unknown systematic type: {name!r}")


@dataclasses.dataclass(frozen=True)
class SystematicDesc:
    """Static description of one systematic acting on one PDF.

    Mirrors the reference SystematicDescriptor (pdfz.cpp:48-54) but is a
    hashable Python object usable as a static jit argument.

    Attributes:
        type: One of SHIFT / SCALE / CTSCALE / RESOLUTION_SCALE.
        obs: Column index of the affected observable field.
        extra_field: Column index of the truth field (RESOLUTION_SCALE only).
        par_indices: Global parameter-vector indices of the power-series
            coefficients p_0..p_{n-1}.
    """

    type: int
    obs: int
    par_indices: Tuple[int, ...]
    extra_field: int = 0

    @property
    def npars(self) -> int:
        return len(self.par_indices)


def apply_systematics(
    samples: jnp.ndarray,
    params: jnp.ndarray,
    systematics: Sequence[SystematicDesc],
) -> jnp.ndarray:
    """Apply all systematics in order to a sample array.

    Args:
        samples: ``(nsamples, nfields)`` float array of MC fields.
        params: 1-D global systematic-parameter vector; each systematic
            reads its coefficients at ``desc.par_indices``.
        systematics: ordered sequence of SystematicDesc (static).

    Returns:
        Transformed samples, same shape/dtype promoted to at least f32.
    """
    if not systematics:
        return samples

    cols = [samples[:, i] for i in range(samples.shape[1])]

    for desc in systematics:
        x = cols[desc.obs]
        # Power series in the *current* observable value.
        p = jnp.zeros_like(x)
        xi = jnp.ones_like(x)
        for i, pidx in enumerate(desc.par_indices):
            if i > 0:
                xi = xi * x
            p = p + params[pidx].astype(x.dtype) * xi

        if desc.type == SHIFT:
            x = x + p
        elif desc.type == SCALE:
            x = x * (1.0 + p)
        elif desc.type == CTSCALE:
            x = 1.0 + (x - 1.0) * (1.0 + p)
        elif desc.type == RESOLUTION_SCALE:
            x = x + p * (x - cols[desc.extra_field])
        else:
            raise ValueError(f"Unknown systematic type id {desc.type}")
        cols[desc.obs] = x

    return jnp.stack(cols, axis=1)
