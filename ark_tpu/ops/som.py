"""Self-organizing map: batch-parallel training + BMU mapping on device.

This replaces the reference's single hottest kernel — pyFlowSOM's C
implementation of FlowSOM's SOM (`reference src/ark/phenotyping/
cluster_helpers.py:98-163`: `som(data, xdim=10, ydim=10, rlen, alpha_range=
(0.05, 0.01), seed)` and `map_data_to_nodes(weights, chunk)` over 1M-row
chunks).

Redesign for an accelerator (SURVEY.md §7 step 2):

* **BMU mapping** is a distance-matmul + argmin: for data X (N×C) and
  weights W (K×C), the BMU is argmin_k ||x−w_k||² = argmin_k (||w_k||² − 2·x·w_kᵀ),
  so the hot op is one (N×C)·(C×K) matmul followed by a row argmin
  (`bmu_xla`, plain XLA; it fuses into the programs that call it).

* **Training** is batch-parallel instead of the reference's strictly
  sequential online updates (which cannot use a matrix unit): data is
  shuffled once (seeded), then scanned in fixed-size minibatches. Each step
  computes batch BMUs, forms the bubble-neighborhood membership matrix
  H (B×K) = [grid_dist(bmu_i, k) ≤ radius_t], and applies the classical batch
  Kohonen update  w_k ← w_k + α_t · (Σ_i H_ik x_i / Σ_i H_ik − w_k)  — two
  more matmuls (HᵀX and Hᵀ1). α and the neighborhood radius decay linearly
  across steps exactly as FlowSOM's online schedule does. Weight parity with
  pyFlowSOM is therefore distribution-level, not bitwise (SURVEY.md §7 hard
  part b); determinism within this framework is exact given a seed.

* Multi-chip: `som_train_sharded` runs the same scan under shard_map with the
  batch sharded over the mesh and a `psum` of the (HᵀX, Hᵀ1) partial sums —
  the one collective-heavy op in the framework (SURVEY.md §2.5).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

def grid_coordinates(xdim: int, ydim: int) -> np.ndarray:
    """(K, 2) grid coordinates for a rectangular SOM, row-major like FlowSOM."""
    gx, gy = np.meshgrid(np.arange(xdim), np.arange(ydim), indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float32)


def grid_distances(xdim: int, ydim: int) -> np.ndarray:
    """(K, K) euclidean distances between SOM grid nodes."""
    pts = grid_coordinates(xdim, ydim)
    d = pts[:, None, :] - pts[None, :, :]
    return np.sqrt((d ** 2).sum(-1)).astype(np.float32)


def default_radius_start(xdim: int, ydim: int) -> float:
    """FlowSOM's default starting radius: the 0.67 quantile of grid distances."""
    return float(np.quantile(grid_distances(xdim, ydim), 0.67))


# ---------------------------------------------------------------------------
# BMU mapping
# ---------------------------------------------------------------------------

def bmu_xla(weights: jax.Array, data: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """BMU search: returns (argmin indices int32, squared distances)."""
    # ||x||^2 - 2 x.w + ||w||^2 ; ||x||^2 needed only for the returned distance
    w2 = jnp.sum(weights * weights, axis=1)                      # (K,)
    # HIGHEST: a default-precision f32 matmul may run in bf16 or TF32,
    # which flips argmins at Voronoi near-ties (f32 parity with the
    # reference's float distances is this module's contract)
    xw = jnp.dot(data, weights.T,
                 precision=jax.lax.Precision.HIGHEST)            # (N, K)
    d = w2[None, :] - 2.0 * xw
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    x2 = jnp.sum(data * data, axis=1)
    best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0] + x2
    return idx, jnp.maximum(best, 0.0)


_bmu_jit = jax.jit(bmu_xla)


@jax.jit
def _bmu_idx(weights: jax.Array, data: jax.Array) -> jax.Array:
    return bmu_xla(weights, data)[0]


def som_map_async(weights, data):
    """Dispatch-only BMU mapping: uploads + launches and returns the
    0-indexed device cluster array WITHOUT materializing it to host
    (``np.asarray`` on the result blocks). Lets callers overlap the h2d
    upload + kernel with host work — e.g. the fused pixie assign loop
    writes FOV i-1's feather while FOV i's BMU is in flight. Labels are
    the same executable `som_map` runs, so results are bitwise-identical
    to the synchronous path."""
    weights = jnp.asarray(weights, jnp.float32)
    data = jnp.asarray(data, jnp.float32)
    if data.shape[0] == 0:
        return jnp.empty(0, jnp.int32)
    return _bmu_idx(weights, data)


def som_map(weights, data,
            return_dist: bool = True) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Map observations to their best-matching SOM node.

    Equivalent of `pyFlowSOM.map_data_to_nodes` (`cluster_helpers.py:150-157`)
    but whole-array on device — no 1M-row Python chunk loop. Returns
    (clusters [1-indexed, matching pyFlowSOM], distances); pass
    `return_dist=False` to skip the distance pass.
    """
    if not return_dist:
        idx = som_map_async(weights, data)
        return np.asarray(idx) + 1, None
    weights = jnp.asarray(weights, jnp.float32)
    data = jnp.asarray(data, jnp.float32)
    if data.shape[0] == 0:
        return (np.empty(0, np.int32),
                np.empty(0, np.float32) if return_dist else None)
    idx, dist = _bmu_jit(weights, data)
    return np.asarray(idx) + 1, np.asarray(dist)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

# fixed scan length: the lr/radius schedule always spans MAX_TRAIN_STEPS
# minibatch updates; batch size absorbs the data size (steps past the real
# n_steps are masked out). A fixed-length scan compiles once for every
# data size, and the pow2 batch buckets mean different cohort sizes reuse
# the same executable.
MAX_TRAIN_STEPS = 256


def _train_scan(data: jax.Array, w0: jax.Array, order: jax.Array,
                gdist: jax.Array, n_steps: jax.Array, batch_size: int,
                lr_start: float, lr_end: float, r_start: float,
                axis_name: Optional[str] = None) -> jax.Array:
    """Batch-Kohonen training: fixed-length scan, first `n_steps` active.

    `order` has MAX_TRAIN_STEPS*batch_size pre-shuffled row indices."""
    denom = jnp.maximum(n_steps - 1, 1).astype(jnp.float32)

    def step(w, t):
        active = t < n_steps
        frac = jnp.minimum(t, n_steps - 1).astype(jnp.float32) / denom
        alpha = lr_start + (lr_end - lr_start) * frac
        radius = r_start * (1.0 - frac)
        rows = jax.lax.dynamic_slice_in_dim(order, t * batch_size, batch_size)
        x = jnp.take(data, rows, axis=0)                         # (B, C)
        w2 = jnp.sum(w * w, axis=1)
        d = w2[None, :] - 2.0 * jnp.dot(
            x, w.T, precision=jax.lax.Precision.HIGHEST)
        bmu = jnp.argmin(d, axis=1)                              # (B,)
        # bubble neighborhood membership (B, K)
        h = (jnp.take(gdist, bmu, axis=0) <= radius).astype(jnp.float32)
        num = jnp.dot(h.T, x,
                      precision=jax.lax.Precision.HIGHEST)       # (K, C)
        den = jnp.sum(h, axis=0)                                 # (K,)
        if axis_name is not None:
            num = jax.lax.psum(num, axis_name)
            den = jax.lax.psum(den, axis_name)
        target = num / jnp.maximum(den, 1.0)[:, None]
        upd = active & (den > 0)[:, None]
        return jnp.where(upd, w + alpha * (target - w), w), None

    w, _ = jax.lax.scan(step, w0, jnp.arange(MAX_TRAIN_STEPS))
    return w


@functools.partial(jax.jit, static_argnames=(
    "batch_size", "lr_start", "lr_end", "r_start"))
def _train_jit(data, w0, order, gdist, n_steps, batch_size, lr_start, lr_end,
               r_start):
    return _train_scan(data, w0, order, gdist, n_steps, batch_size,
                       lr_start, lr_end, r_start)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _schedule_batch(total: int, batch_size: Optional[int]) -> int:
    """Batch size so the FULL fixed-length schedule (MAX_TRAIN_STEPS active
    updates) runs for any data size: large inputs get total/256-row batches;
    small inputs wrap their permutation into extra passes (the batch analog
    of online SOM's per-observation updates — a floor that swallowed the
    dataset used to leave small/cell-table SOMs at ~1 update, i.e. frozen at
    init). `batch_size` is an explicit override (clamped to pow2 bounds)."""
    if batch_size is not None:
        return int(np.clip(_next_pow2(batch_size) if batch_size & (batch_size - 1)
                           else batch_size, 8, 1 << 16))
    return int(np.clip(_next_pow2(max(total // MAX_TRAIN_STEPS, 1)),
                       8, 1 << 16))


def _prepare_train(data, xdim, ydim, num_passes, seed, batch_size,
                   radius_start, weights_init):
    """Host-side training prep shared by som_train / som_train_and_map:
    seeded init + visiting order, pow2 data padding, schedule constants.
    Returns (data_padded, w0, order, gdist, bs, r0, n)."""
    # device-resident inputs stay on device (only index math runs on host);
    # host inputs pay exactly one transfer
    on_device = isinstance(data, jax.Array)
    if on_device:
        data = data.astype(jnp.float32)
    else:
        data = np.asarray(data, np.float32)
    if data.ndim != 2:
        raise ValueError(
            f"SOM training data must be 2-D (rows, channels); got shape "
            f"{data.shape}")
    n = data.shape[0]
    if n == 0:
        raise ValueError("cannot train SOM on empty data")
    k = xdim * ydim
    # seeded host RNG for init/shuffle: deterministic, and avoids per-n
    # device-RNG compiles (jax.random.permutation jits per input size)
    host_rng = np.random.default_rng(seed)

    if weights_init is None:
        # FlowSOM initializes codes from a random sample of observations
        init_rows = host_rng.choice(n, size=k, replace=n < k)
        if on_device:
            w0 = jnp.take(data, jnp.asarray(init_rows.astype(np.int32)),
                          axis=0)
        else:
            w0 = jnp.asarray(data[init_rows])
    else:
        w0 = jnp.asarray(weights_init, jnp.float32)

    total = int(num_passes) * n
    # every training run makes MAX_TRAIN_STEPS active updates over the full
    # lr/radius schedule; the batch absorbs the data size (wrapped visiting
    # order for small inputs — see _schedule_batch)
    bs = _schedule_batch(total, batch_size)
    # seeded shuffled visiting order, wrapped to the fixed scan extent; data
    # rows are pow2-padded so cohort sizes reuse few compiled executables
    perm = host_rng.permutation(n)
    order_len = MAX_TRAIN_STEPS * bs
    reps = (order_len + n - 1) // n
    order = jnp.asarray(np.tile(perm, reps)[:order_len].astype(np.int32))
    data_pad = _next_pow2(n)
    if on_device:
        data_padded = jnp.pad(data, ((0, data_pad - n), (0, 0)))
    else:
        data_padded = jnp.asarray(np.pad(data, ((0, data_pad - n), (0, 0))))

    r0 = radius_start if radius_start is not None \
        else default_radius_start(xdim, ydim)
    gdist = jnp.asarray(grid_distances(xdim, ydim))
    return data_padded, w0, order, gdist, bs, r0, n


def som_train(data, xdim: int = 10, ydim: int = 10, num_passes: int = 1,
              lr_start: float = 0.05, lr_end: float = 0.01, seed: int = 42,
              batch_size: Optional[int] = None,
              radius_start: Optional[float] = None,
              weights_init: Optional[np.ndarray] = None) -> np.ndarray:
    """Train a SOM, batch-parallel (defaults mirror `cluster_helpers.py:
    54-56` / `pixel_som_clustering.py:19-21`: 10×10 grid, 1 pass, lr .05→.01,
    seed 42). Returns (xdim*ydim, C) float32 weights."""
    data_padded, w0, order, gdist, bs, r0, _ = _prepare_train(
        data, xdim, ydim, num_passes, seed, batch_size, radius_start,
        weights_init)
    w = _train_jit(data_padded, w0, order, gdist,
                   jnp.int32(MAX_TRAIN_STEPS), bs,
                   float(lr_start), float(lr_end), float(r0))
    return np.asarray(w)


@functools.partial(jax.jit, static_argnames=(
    "batch_size", "lr_start", "lr_end", "r_start"))
def _train_map_jit(data, w0, order, gdist, n_steps, batch_size, lr_start,
                   lr_end, r_start):
    w = _train_scan(data, w0, order, gdist, n_steps, batch_size,
                    lr_start, lr_end, r_start)
    idx, dist = bmu_xla(w, data)
    return w, idx, dist


def som_train_and_map(data, xdim: int = 10, ydim: int = 10,
                      num_passes: int = 1, lr_start: float = 0.05,
                      lr_end: float = 0.01, seed: int = 42,
                      batch_size: Optional[int] = None,
                      radius_start: Optional[float] = None,
                      weights_init: Optional[np.ndarray] = None):
    """Train a SOM and assign every training row its BMU in ONE jitted
    program — a single dispatch+readback where `som_train` + `som_map` pay
    two, so cell-table flows that train and map the same matrix should
    prefer this.

    Bitwise-identical to `som_train(...)` followed by
    `som_map(weights, data)` (same seeded init/visiting order).
    Returns (weights (K, C) f32, clusters (N,) 1-indexed, distances (N,)).
    """
    data_padded, w0, order, gdist, bs, r0, n = _prepare_train(
        data, xdim, ydim, num_passes, seed, batch_size, radius_start,
        weights_init)
    w, idx, dist = _train_map_jit(data_padded, w0, order, gdist,
                                  jnp.int32(MAX_TRAIN_STEPS), bs,
                                  float(lr_start), float(lr_end), float(r0))
    # padded rows (zeros) are mapped too, then dropped here: keeping the map
    # inside the one compiled program beats a dynamic-shape slice on device
    return np.asarray(w), np.asarray(idx[:n]) + 1, np.asarray(dist[:n])


def som_train_sharded(data, mesh, data_axis: str = "fov", xdim: int = 10,
                      ydim: int = 10, num_passes: int = 1,
                      lr_start: float = 0.05, lr_end: float = 0.01,
                      seed: int = 42, batch_size: Optional[int] = None,
                      radius_start: Optional[float] = None,
                      weights_init: Optional[np.ndarray] = None) -> np.ndarray:
    """Multi-chip SOM training: the full lr/radius schedule as ONE jitted
    sharded scan — rows row-sharded over `data_axis`, each device scanning
    its local visiting order, with the (HᵀX, Hᵀ1) batch statistics psum'd
    across devices every step (SURVEY.md §2.5(c)). This is the same
    `_train_scan` program as single-chip training with `axis_name` wired
    through shard_map, so the whole schedule is a single dispatch.

    Data placement: rows are shuffled once (seeded) and split contiguously
    across devices, so each device's shard is an iid sample; every global
    minibatch is the union of per-device local minibatches. Semantics match
    `som_train` (same schedule/init); the batch partitioning differs, so
    weights agree distributionally, not bitwise.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    host_data = np.asarray(jax.device_get(data), np.float32) \
        if isinstance(data, jax.Array) else np.asarray(data, np.float32)
    n, c = host_data.shape
    if n == 0:
        raise ValueError("cannot train SOM on empty data")
    k = xdim * ydim
    # shard count along the DATA axis only — mesh.devices.size would build
    # per-device visiting orders for every device of a multi-axis mesh
    # while shard_map splits rows over just this axis, silently leaving
    # half of each shard's rows unvisited
    n_dev = int(mesh.shape[data_axis])
    host_rng = np.random.default_rng(seed)

    if weights_init is None:
        init_rows = host_rng.choice(n, size=k, replace=n < k)
        w0 = jnp.asarray(host_data[init_rows])
    else:
        w0 = jnp.asarray(weights_init, jnp.float32)

    total = int(num_passes) * n
    bs = _schedule_batch(total, batch_size)
    bs = max((bs // n_dev) * n_dev, n_dev)            # divisible shards
    bs_local = bs // n_dev
    n_steps = MAX_TRAIN_STEPS

    # shuffle rows once, then row-shard: device d owns rows
    # perm[d*n_local:(d+1)*n_local] (wrapped duplicates pad the tail)
    n_local = _next_pow2((n + n_dev - 1) // n_dev)
    perm = host_rng.permutation(n)
    shard_rows = np.resize(perm, n_local * n_dev)
    data_sharded = jax.device_put(host_data[shard_rows],
                                  NamedSharding(mesh, P(data_axis)))
    # per-device local visiting orders over real local rows only
    order_len = MAX_TRAIN_STEPS * bs_local
    n_real_local = min(n, n_local)
    orders = np.stack([
        np.resize(host_rng.permutation(n_real_local), order_len)
        for _ in range(n_dev)]).astype(np.int32).reshape(-1)
    order_sharded = jax.device_put(orders, NamedSharding(mesh, P(data_axis)))

    r0 = radius_start if radius_start is not None \
        else default_radius_start(xdim, ydim)
    gdist = jnp.asarray(grid_distances(xdim, ydim))

    def local_train(data_l, w0, order_l, gdist, n_steps):
        return _train_scan(data_l, w0, order_l, gdist, n_steps, bs_local,
                           float(lr_start), float(lr_end), float(r0),
                           axis_name=data_axis)

    fn = jax.jit(jax.shard_map(
        local_train, mesh=mesh,
        in_specs=(P(data_axis), P(), P(data_axis), P(), P()),
        out_specs=P()))
    w = fn(data_sharded, w0, order_sharded, gdist, jnp.int32(n_steps))
    return np.asarray(w)


def make_sharded_train_step(mesh, data_axis: str = "fov"):
    """Return a jitted multi-chip SOM train-step: batch sharded over
    `data_axis`, partial (HᵀX, Hᵀ1) sums all-reduced across devices
    (SURVEY.md §2.5).

    The returned fn signature: step(w, x_batch, alpha, radius, gdist) -> w.
    """
    from jax.sharding import PartitionSpec as P

    def local_step(w, x, alpha, radius, gdist):
        w2 = jnp.sum(w * w, axis=1)
        d = w2[None, :] - 2.0 * jnp.dot(
            x, w.T, precision=jax.lax.Precision.HIGHEST)
        bmu = jnp.argmin(d, axis=1)
        h = (jnp.take(gdist, bmu, axis=0) <= radius).astype(jnp.float32)
        num = jax.lax.psum(
            jnp.dot(h.T, x, precision=jax.lax.Precision.HIGHEST), data_axis)
        den = jax.lax.psum(jnp.sum(h, axis=0), data_axis)
        target = num / jnp.maximum(den, 1.0)[:, None]
        return jnp.where((den > 0)[:, None], w + alpha * (target - w), w)

    fn = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(data_axis), P(), P(), P()),
        out_specs=P(),
    )
    return jax.jit(fn)
