"""Worker script for the real N-process distributed render test.

Launched by tests/test_multihost.py with argv:
    multihost_worker.py <coordinator> <num_procs> <proc_id> <out.npz>

Each process owns 8/num_procs virtual CPU devices; the global mesh is
(bricks=4, rays=2) across 8 devices, so the BRICKS axis spans every
process boundary: with 2 processes bricks 0-1|2-3 split across them, with
4 processes every brick row lives on its own process and all three halo
``ppermute`` edges cross boundaries (asserted structurally below from the
mesh's device placement). Process 0 writes the gathered results to
<out.npz>:

- ``scan``: the scan-marcher bricks render (parallel/bricks.py),
- ``sweep``: the distributed object-order sweep (parallel/sweep.py, XLA
  backend on CPU) with n_planes chosen so the z pre-blend NEEDS the
  cross-process ghost layers (no pure-selection shortcut),
- ``g_vol`` / ``g_lut``: gradients of a scalar loss through the distributed
  sweep (the shard_map transpose returns ghost-layer cotangents across the
  process boundary and psums the LUT gradient over the whole mesh).
"""

import os
import sys

coordinator, num_procs, proc_id, out_path = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
)
devices_per_proc = 8 // num_procs
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={devices_per_proc}"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=coordinator, num_processes=num_procs, process_id=proc_id
)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jax.experimental import multihost_utils  # noqa: E402

from vrdd_tpu.core.geometry import default_benchmark_inv_view  # noqa: E402
from vrdd_tpu.core.transfer import default_transfer_function  # noqa: E402
from vrdd_tpu.io.synthetic import gaussian_blob_volume  # noqa: E402
from vrdd_tpu.parallel.bricks import distributed_render_image  # noqa: E402
from vrdd_tpu.parallel.sweep import (  # noqa: E402
    distributed_sweep_render,
    shard_scalar_volume,
)
from vrdd_tpu.parallel import multihost  # noqa: E402
from vrdd_tpu.utils.config import MarchConfig  # noqa: E402

assert len(jax.devices()) == 8, jax.devices()
mesh = multihost.global_mesh(bricks=4, rays=2)

# --- the bricks axis must SPAN the process boundary: each brick row sits on
# one process, and consecutive rows 1|2 sit on different processes, so their
# halo ppermute crosses it (SURVEY.md §4 multi-process requirement) ---
brick_procs = [
    sorted({d.process_index for d in row}) for row in mesh.devices
]
expected = [[i * num_procs // 4] for i in range(4)]
assert brick_procs == expected, (brick_procs, expected)

vol = gaussian_blob_volume((8, 8, 8), seed=11)
stats = np.stack([vol, vol * 0.5, 1.0 - vol], axis=-1).astype(np.float32)
stats_g = multihost.make_global(stats, mesh, multihost.stats_volume_spec())

march = MarchConfig(max_steps=50, tstep=0.05)
img = distributed_render_image(
    stats_g,
    jnp.asarray(default_benchmark_inv_view()),
    jnp.asarray(default_transfer_function()),
    jnp.float32(0.1), jnp.float32(1.0), jnp.float32(0.0), jnp.float32(1.0),
    width=16, height=16, channel=0, march=march, mesh=mesh,
)
scan_full = multihost.gather_image(img)

# --- distributed sweep + gradients across the process boundary ---
# n_planes=16 over nz=8: fractional z taps => the pre-blend reads the
# cross-process ghost layers (n_planes == nz would reduce to pure selection)
tf = jnp.asarray(default_transfer_function())
vol_g = shard_scalar_volume(
    jnp.asarray(gaussian_blob_volume((8, 16, 16), seed=7)), mesh
)
origin = jnp.asarray([0.0, 0.0, 4.0], dtype=jnp.float32)


def loss_fn(v, lut):
    out = distributed_sweep_render(
        v, origin, lut, jnp.float32(0.3),
        width=16, height=16, march=march, mesh=mesh, n_planes=16,
    )
    return jnp.mean((out - 0.25) ** 2), out

(loss, sweep_img), (g_vol, g_lut) = jax.value_and_grad(
    loss_fn, argnums=(0, 1), has_aux=True
)(vol_g, tf)

sweep_full = multihost.gather_image(sweep_img)
g_vol_full = np.asarray(multihost_utils.process_allgather(g_vol, tiled=True))
g_lut_full = np.asarray(g_lut)  # replicated: psum'd over the whole mesh

if proc_id == 0:
    np.savez(
        out_path, scan=scan_full, sweep=sweep_full,
        g_vol=g_vol_full, g_lut=g_lut_full, loss=float(loss),
    )
print(f"proc {proc_id} done", flush=True)
