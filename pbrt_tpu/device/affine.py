"""Explicit-arithmetic affine transforms for geometry.

These replace `jnp.einsum` at every ray/point/normal transform site. A
3-wide einsum contraction lowers to a `dot_general`, which may be handed to
a matrix unit at reduced precision — wasteful for 3x4 matrices, and a way
to round geometry. Written as explicit multiply-adds these stay elementwise
at full f32 precision and fuse with neighbouring elementwise work.

All helpers broadcast: `m` may be a static (3, 4) / (4, 4) matrix or a
batched (..., 3, 4) stack; `p`/`v`/`n` are (..., 3) with any mutually
broadcastable leading shape (e.g. the brute-force intersector passes
m=(1, P, 3, 4) against p=(R, 1, 3)).

Semantic reference: src/core/transform.rs (transform_point/vector/normal).
"""
from __future__ import annotations

import jax.numpy as jnp


def xf_point(m, p):
    """Affine point transform: rows 0..2 of m applied to p, plus translation."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return jnp.stack(
        [
            m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z + m[..., 0, 3],
            m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z + m[..., 1, 3],
            m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z + m[..., 2, 3],
        ],
        axis=-1,
    )


def xf_vector(m, v):
    """Linear (no-translation) transform of a direction."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
            m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
            m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z,
        ],
        axis=-1,
    )


def xf_vector_t(m, v):
    """Transpose transform: out_i = sum_j m[j, i] * v_j.

    Used for normals (apply (M^-1)^T by passing the inverse matrix) and for
    world->local frames stored as local->world rotations.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            m[..., 0, 0] * x + m[..., 1, 0] * y + m[..., 2, 0] * z,
            m[..., 0, 1] * x + m[..., 1, 1] * y + m[..., 2, 1] * z,
            m[..., 0, 2] * x + m[..., 1, 2] * y + m[..., 2, 2] * z,
        ],
        axis=-1,
    )


def apply44_point(m, p):
    """Projective 4x4 point transform with homogeneous divide."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = jnp.stack(
        [
            m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z + m[..., 0, 3],
            m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z + m[..., 1, 3],
            m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z + m[..., 2, 3],
        ],
        axis=-1,
    )
    w = m[..., 3, 0] * x + m[..., 3, 1] * y + m[..., 3, 2] * z + m[..., 3, 3]
    return r / w[..., None]
