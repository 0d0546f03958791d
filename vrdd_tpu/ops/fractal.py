"""Similarity/fractal histogram decoding.

A fractal-coded histogram is ``(templateId, shift, flipFlag, nErrors)`` plus a
sparse error list. Decoding = take template, optionally flip, circular-shift,
add sparse errors (clamping at 0), renormalize — the semantics of
fractalDecoding / flexibleFractalDecoding + the error-merge in
d_basicDataProcessing (volumeRender_kernel.cu:195-251, 775-839).

Data-parallel design: instead of per-thread scalar loops, the decode is a pure
vectorized op — flip via ``jnp.flip``, shift via one-hot *roll matrix* matmul
(vectorizes the data-dependent shift across a whole codebook without gathers),
error merge via masked scatter-add, renormalize as a reduction. Differentiable
w.r.t. templates and error values (the "per-voxel distribution params" of the
north star).

NOTE: the reference applies errors sequentially with clamp-after-each
(volumeRender_kernel.cu:817-820). We scatter-add all errors then clamp once,
which is identical when bin ids within one histogram are unique (they are, by
construction of the encoder — one error entry per bin).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp


def _roll_rows(x: jnp.ndarray, shift: jnp.ndarray) -> jnp.ndarray:
    """Row-wise circular shift: ``out[b, (i + shift[b]) % n] = x[b, i]``.

    Implemented as a gather with precomputed indices.
    """
    n = x.shape[-1]
    j = jnp.arange(n, dtype=jnp.int32)
    src = (j[None, :] - shift[:, None]) % n  # out[b, j] = x[b, j - shift]
    return jnp.take_along_axis(x, src, axis=-1)


def fractal_decode(
    template: jnp.ndarray,
    shift: jnp.ndarray,
    flip: jnp.ndarray,
    error_bins: Optional[jnp.ndarray] = None,
    error_values: Optional[jnp.ndarray] = None,
    n_errors: Optional[jnp.ndarray] = None,
    renormalize: bool = True,
) -> jnp.ndarray:
    """Decode one fractal-coded histogram.

    Args:
      template: ``(n_bins,)`` template frequencies.
      shift: scalar int circular shift.
      flip: scalar int/bool reflection flag.
      error_bins: ``(max_errors,)`` int bin ids (may be padded).
      error_values: ``(max_errors,)`` float corrections.
      n_errors: scalar int count of valid error entries.
      renormalize: divide by the post-merge total (guarded against 0).

    Returns ``(n_bins,)`` decoded histogram.
    """
    return fractal_decode_batch(
        template[None],
        shift[None] if jnp.ndim(shift) == 0 else shift,
        flip[None] if jnp.ndim(flip) == 0 else flip,
        None if error_bins is None else error_bins[None],
        None if error_values is None else error_values[None],
        None if n_errors is None else jnp.atleast_1d(n_errors),
        renormalize=renormalize,
    )[0]


def fractal_decode_batch(
    templates: jnp.ndarray,
    shift: jnp.ndarray,
    flip: jnp.ndarray,
    error_bins: Optional[jnp.ndarray] = None,
    error_values: Optional[jnp.ndarray] = None,
    n_errors: Optional[jnp.ndarray] = None,
    renormalize: bool = True,
) -> jnp.ndarray:
    """Decode a batch of fractal-coded histograms.

    Args:
      templates: ``(B, n_bins)`` per-entry template rows (pre-gathered by
        templateId — do ``all_templates[codebook[:, 0]]`` at the call site).
      shift / flip: ``(B,)`` ints.
      error_bins / error_values: ``(B, E)`` padded sparse errors.
      n_errors: ``(B,)`` valid counts.

    Returns ``(B, n_bins)``.
    """
    templates = jnp.asarray(templates, dtype=jnp.float32)
    n = templates.shape[-1]
    flipped = jnp.where(
        (flip != 0)[:, None], jnp.flip(templates, axis=-1), templates
    )
    decoded = _roll_rows(flipped, jnp.asarray(shift, dtype=jnp.int32))

    if error_bins is not None:
        eb = jnp.asarray(error_bins, dtype=jnp.int32)
        ev = jnp.asarray(error_values, dtype=jnp.float32)
        if n_errors is not None:
            k = jnp.arange(eb.shape[-1], dtype=jnp.int32)
            valid = k[None, :] < jnp.asarray(n_errors, dtype=jnp.int32)[:, None]
            ev = jnp.where(valid, ev, 0.0)
        # masked scatter-add: one-hot over bins, contracted over error slots.
        onehot = (eb[..., None] == jnp.arange(n, dtype=jnp.int32)).astype(jnp.float32)
        decoded = decoded + jnp.einsum("be,ben->bn", ev, onehot)
        decoded = jnp.maximum(decoded, 0.0)

    if renormalize:
        total = jnp.sum(decoded, axis=-1, keepdims=True)
        decoded = jnp.where(total > 0.0, decoded / jnp.where(total > 0.0, total, 1.0), decoded)
    return decoded
