"""Synthetic dataset generators for the BASELINE.json configs and parity tests.

The reference ships no data; its loaders expect Isabel/Fuel-derived binary
blobs (volumeRender.cpp:76-84). For testing and benchmarking we generate
volumes with the same *shapes and invariants* (normalized histograms, valid
codebooks) deterministically from seeds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_blob_volume(
    shape: Tuple[int, int, int] = (64, 64, 64),
    n_blobs: int = 4,
    seed: int = 0,
) -> np.ndarray:
    """Sum-of-Gaussians scalar volume in [0, 1] — the 64^3 PR1 config."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    z, y, x = np.meshgrid(
        np.linspace(0, 1, nz), np.linspace(0, 1, ny), np.linspace(0, 1, nx),
        indexing="ij",
    )
    vol = np.zeros(shape, dtype=np.float64)
    for _ in range(n_blobs):
        c = rng.uniform(0.2, 0.8, size=3)
        s = rng.uniform(0.05, 0.2)
        a = rng.uniform(0.5, 1.0)
        vol += a * np.exp(
            -((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) / (2 * s * s)
        )
    vol /= vol.max()
    return vol.astype(np.float32)


def block_histograms_from_scalar(
    vol: np.ndarray,
    block_shape: Tuple[int, int, int],
    n_bins: int = 32,
    vmax: float = 1.0,
) -> np.ndarray:
    """Data-reduction encoder: raw scalar volume -> per-block normalized histograms.

    This is the preprocessing the reference assumes was done offline (the
    Isabel 500x500x100 -> 50x50x10 blocks x 32 bins reduction described in the
    presentation's results table). Returns ``(Zb, Yb, Xb, n_bins)``.
    """
    bz, by, bx = block_shape
    nz, ny, nx = vol.shape
    assert nz % bz == 0 and ny % by == 0 and nx % bx == 0, "volume must tile"
    zb, yb, xb = nz // bz, ny // by, nx // bx
    blocks = vol.reshape(zb, bz, yb, by, xb, bx).transpose(0, 2, 4, 1, 3, 5)
    blocks = blocks.reshape(zb, yb, xb, -1)
    bins = np.clip((blocks / vmax * n_bins).astype(np.int64), 0, n_bins - 1)
    hist = np.zeros((zb, yb, xb, n_bins), dtype=np.float32)
    for b in range(n_bins):
        hist[..., b] = (bins == b).sum(axis=-1)
    hist /= blocks.shape[-1]
    return hist


def random_histogram_volume(
    shape: Tuple[int, int, int] = (10, 50, 50),
    n_bins: int = 32,
    seed: int = 0,
    concentration: float = 0.5,
) -> np.ndarray:
    """Random normalized per-block histograms (Dirichlet), Isabel-shaped default."""
    rng = np.random.default_rng(seed)
    h = rng.gamma(concentration, size=(*shape, n_bins)).astype(np.float32)
    h /= h.sum(axis=-1, keepdims=True)
    return h


def synthetic_fractal_volume(
    shape: Tuple[int, int, int] = (10, 50, 50),
    n_bins: int = 32,
    n_templates: int = 16,
    max_errors: int = 8,
    seed: int = 0,
):
    """Generate a consistent (templates, codebook, errors, expected_decode) tuple.

    ``expected_decode`` is computed by an independent numpy decode loop, so it
    doubles as the test oracle for :func:`vrdd_tpu.ops.fractal.fractal_decode_batch`.
    Returns ``(templates (T, B), codebook (Z, Y, X, 4), error_bins (Z, Y, X, E),
    error_values (Z, Y, X, E), expected (Z, Y, X, B))``.
    """
    rng = np.random.default_rng(seed)
    t = rng.gamma(1.0, size=(n_templates, n_bins)).astype(np.float32)
    t /= t.sum(axis=-1, keepdims=True)

    n = int(np.prod(shape))
    template_id = rng.integers(0, n_templates, size=n)
    shift = rng.integers(0, n_bins, size=n)
    flip = rng.integers(0, 2, size=n)
    n_errors = rng.integers(0, max_errors + 1, size=n)
    codebook = np.stack([template_id, shift, flip, n_errors], axis=-1).astype(np.int32)

    error_bins = np.zeros((n, max_errors), dtype=np.int32)
    error_values = np.zeros((n, max_errors), dtype=np.float32)
    expected = np.zeros((n, n_bins), dtype=np.float32)
    for i in range(n):
        tt = t[template_id[i]].copy()
        if flip[i]:
            tt = tt[::-1].copy()
        dec = np.zeros(n_bins, dtype=np.float32)
        for j in range(n_bins):
            dec[(j + shift[i]) % n_bins] = tt[j]
        bins = rng.choice(n_bins, size=n_errors[i], replace=False)
        vals = rng.uniform(-0.05, 0.05, size=n_errors[i]).astype(np.float32)
        error_bins[i, : n_errors[i]] = bins
        error_values[i, : n_errors[i]] = vals
        for b, v in zip(bins, vals):
            dec[b] += v
            if dec[b] < 0:
                dec[b] = 0.0
        s = dec.sum()
        if s > 0:
            dec /= s
        expected[i] = dec

    z, y, x = shape
    return (
        t,
        codebook.reshape(z, y, x, 4),
        error_bins.reshape(z, y, x, max_errors),
        error_values.reshape(z, y, x, max_errors),
        expected.reshape(z, y, x, n_bins),
    )


def synthetic_flexible_dataset(
    dims: Tuple[int, int, int] = (16, 16, 16),
    n_bins: int = 64,
    seed: int = 0,
    error_fraction: float = 0.25,
    max_errors: int = 4,
):
    """Reference-structured flexible-block dataset from a known raw volume.

    Generates the full Fenwick span universe (what the reference's
    codebook0/nzb* files store for the 64^3 Fuel volume) from a random raw
    volume: spans >= 8 voxels are fractal-encoded (with exact inverse
    templates, a fraction carrying sparse error corrections), smaller spans
    become sparse "simple" histograms (0-indexed spans, the reference quirk at
    volumeRender_kernel.cu:1464-1471).

    Returns a dict with the raw volume and every array
    :meth:`vrdd_tpu.models.flexible.FlexibleBlockVolume.from_codebooks` needs.
    """
    from vrdd_tpu.ops.integral import all_fenwick_triples, span_sizes

    rng = np.random.default_rng(seed)
    dx, dy, dz = dims
    raw = rng.integers(0, 256, size=(dz, dy, dx)).astype(np.float32)

    # numpy integral histogram (independent of the jax implementation)
    bins = np.clip((raw / 256.0 * n_bins).astype(np.int64), 0, n_bins - 1)
    oh = np.zeros((dz, dy, dx, n_bins), dtype=np.float64)
    for b in range(n_bins):
        oh[..., b] = bins == b
    sat = oh.cumsum(0).cumsum(1).cumsum(2)
    sat = np.pad(sat, ((1, 0), (1, 0), (1, 0), (0, 0)))

    spans = all_fenwick_triples(dims)  # (n, 6) 1-indexed xyz
    sizes = span_sizes(spans)

    def span_hists(rows):
        """Vectorized 8-corner span histograms, normalized: (m, n_bins)."""
        lx, ly, lz = rows[:, 0], rows[:, 1], rows[:, 2]
        hx, hy, hz = rows[:, 3], rows[:, 4], rows[:, 5]
        h = (
            sat[hz, hy, hx] - sat[lz - 1, hy, hx] - sat[hz, ly - 1, hx]
            - sat[hz, hy, lx - 1] + sat[lz - 1, ly - 1, hx]
            + sat[lz - 1, hy, lx - 1] + sat[hz, ly - 1, lx - 1]
            - sat[lz - 1, ly - 1, lx - 1]
        )
        return h / h.sum(axis=-1, keepdims=True)

    fractal_mask = sizes >= 8
    f_rows = spans[fractal_mask]
    s_rows = spans[~fractal_mask]

    # fractal-encode every >=8-voxel span (vectorized over the whole bank):
    # the template is the exact inverse of flip(shift(h)), then a fraction of
    # rows get sparse post-decode error corrections carved out of the
    # template so decode(template) + errors == h exactly
    nf = len(f_rows)
    h_all = span_hists(f_rows).astype(np.float32)
    shift = rng.integers(0, n_bins, size=nf)
    flip = rng.integers(0, 2, size=nf)
    j = np.arange(n_bins)
    templates = np.take_along_axis(
        h_all, (j[None, :] + shift[:, None]) % n_bins, axis=1
    )
    templates = np.where(flip[:, None] == 1, templates[:, ::-1], templates)
    has_err = rng.random(nf) < error_fraction
    ne = np.where(has_err, rng.integers(1, max_errors + 1, size=nf), 0)
    # ne distinct decoded bins per row via random-matrix argsort; the
    # shift/flip mapping decoded-bin -> template-position is bijective, so
    # distinct targets touch distinct template entries (scatter is exact)
    target = np.argsort(rng.random((nf, n_bins)), axis=1)[:, :max_errors]
    jpos = (target - shift[:, None]) % n_bins
    tpos = np.where(flip[:, None] == 1, n_bins - 1 - jpos, jpos)
    emask = np.arange(max_errors)[None, :] < ne[:, None]
    delta = np.minimum(
        np.float32(0.01), np.take_along_axis(templates, tpos, axis=1) * 0.5
    ) * emask
    np.put_along_axis(
        templates, tpos,
        np.take_along_axis(templates, tpos, axis=1) - delta, axis=1,
    )
    templates = templates.astype(np.float32)
    error_bins = (target * emask).astype(np.int32)
    error_values = delta.astype(np.float32)
    codebook = np.stack(
        [np.arange(nf), shift, flip, ne], axis=-1
    ).astype(np.int32)

    # sparse "simple" encoding of every < 8-voxel span (vectorized):
    # stable-sort nonzero bins to the front of each row
    ns = len(s_rows)
    max_nnz = n_bins
    h_s = span_hists(s_rows)
    nzmask = h_s > 0
    simple_counts = nzmask.sum(axis=1).astype(np.int32)
    order = np.argsort(~nzmask, axis=1, kind="stable")[:, :max_nnz]
    keep = np.arange(max_nnz)[None, :] < simple_counts[:, None]
    simple_bin_ids = (order * keep).astype(np.int32)
    simple_freqs = (
        np.take_along_axis(h_s, order, axis=1) * keep
    ).astype(np.float32)

    return dict(
        raw=raw,
        volume_dim=dims,
        fractal_spans=f_rows,
        fractal_codebook=codebook,
        fractal_error_bins=error_bins,
        fractal_error_values=error_values,
        templates=templates,
        simple_spans=s_rows - 1,  # 0-indexed, reference quirk
        simple_bin_ids=simple_bin_ids,
        simple_freqs=simple_freqs,
        simple_counts=simple_counts,
    )


def device_blob_volume(n: int, seed: int = 0):
    """A float32 ``(n, n, n)`` sum of three separable gaussians with peak
    1, generated on the device: only the seeded blob parameters come from
    the host, so a 1024^3 field (4.3 GB) costs no upload."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    cs = [rng.uniform(0.3, 0.7, size=3).astype(np.float32) for _ in range(3)]
    ss = [np.float32(rng.uniform(0.1, 0.25)) for _ in range(3)]

    @jax.jit
    def gen():
        z = jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)
        vol = jnp.zeros((n, n, n), jnp.float32)
        for c, s in zip(cs, ss):
            g = [jnp.exp(-((z - c[k]) ** 2) / (2 * s * s)) for k in range(3)]
            vol = vol + (g[0][:, None, None] * g[1][None, :, None]
                         * g[2][None, None, :])
        return vol / jnp.max(vol)

    return gen()


def device_histogram_volume(
    n: int, n_bins: int = 16, seed: int = 0, dtype="bfloat16"
):
    """A bins-MAJOR ``(n, n_bins, n, n)`` histogram volume generated on the
    device: per-voxel softmax histograms peaked around the
    :func:`device_blob_volume` mean field (structured like the
    raw-histogram data of volumeRender_kernel.cu:722-742), so a
    512^3 x 16-bin volume (4.3 GB in bf16) costs no upload."""
    import jax
    import jax.numpy as jnp

    centers = ((np.arange(n_bins, dtype=np.float32) + 0.5)
               / n_bins)[:, None, None]

    def layer(b):
        # one z-layer at a time, so the f32 logits never exceed one
        # (n_bins, n, n) layer
        logits = -((centers - b[None]) ** 2) / 0.02
        return jax.nn.softmax(logits, axis=0).astype(dtype)

    return jax.jit(lambda base: jax.lax.map(layer, base))(
        device_blob_volume(n, seed)
    )
