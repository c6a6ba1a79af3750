"""Watershed segmentation: native C++ priority-flood (host) and batched
device floods.

Used by the Mesmer deep-watershed postprocess and the classical fiber
pipeline (reference delegates to skimage's watershed;
`fiber_segmentation.py:324-356`).

Device formulation. Priority-flood assigns pixel p the
label of the marker minimizing the minimax path value f(m, p) = min over
4-connected paths m=x0..xk=p of max(q[x0..x_{k-1}]) — p's OWN height is
excluded because a pixel is claimed when its best neighbor pops, and a
marker starts expanding at its own bucket (see the C++ kernel's push/pop
discipline below).

TWO device engines compute the same claim sets (`_ENGINE` selects;
parity contract identical, tests/ops/test_watershed_device.py):

- **minimax relaxation** (default, r4): packed (value, label) Bellman
  iteration on v(p) = min_u max(v(u), q(u)) with fast-sweeping
  associative-scan acceleration, then a BFS re-labeling pass over
  optimal edges that reproduces the host's FIFO-within-bucket tie
  splitting. Rounds scale with basin radius, NOT with the level count —
  see `_flood_minimax` and the comment block above it.
- **level scan** (r3): 256 sequential levels, per level BFS claim rounds
  with an exact CC-based phase-B backstop:

  for level l in 0..levels-1 (one `lax.scan`):
    sources   = labeled pixels with q <= l      (eligible to expand)
    claim     = any unlabeled masked pixel adjacent to a source
    phase A:  `bfs_rounds` claim rounds — each round expands the labeled
              set one geodesic step, so ties between basins resolve by
              BFS distance, matching the FIFO-within-bucket order of the
              host kernel up to push order;
    phase B:  if phase A did not converge (long conductive corridors), the
              level is finished EXACTLY in logarithmic rounds: connected
              components of the conductive set {mask & q <= l} (batched
              Shiloach–Vishkin, `ops/cc.py`), then every component takes
              the minimum source label it touches, then one frontier claim
              round for non-conductive neighbors. Tie-breaking inside a
              still-contested region falls from BFS-distance to min-label
              here — the claim SETS (which basin-complex floods what, and
              total coverage) remain exact; only equidistant-tie ownership
              can differ from the host kernel.

Both loops are fixed-length scans with `lax.cond` early-outs (bounded
programs — see `ops/cc.py`). Coverage is
exact by construction: at the last level every masked pixel is conductive,
so phase B labels everything reachable from a marker within the mask —
`(device > 0) == (host > 0)` always (tested). The returned flag certifies
the internal SV budgets converged (always, in practice); the `*_np`
wrapper falls back to the native kernel per image when it is ever False.
"""

from __future__ import annotations

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ark_tpu.ops import cc


def watershed(image: np.ndarray, markers: np.ndarray,
              mask: np.ndarray = None) -> np.ndarray:
    """Marker-based watershed on `image` (flood ascending values), restricted
    to `mask`. 4-connected; returns int32 labels."""
    from ark_tpu import native
    lib = native.get_lib()
    image = np.ascontiguousarray(image, np.float32)
    markers = np.ascontiguousarray(markers, np.int32)
    if mask is None:
        mask = np.ones(image.shape, np.uint8)
    mask = np.ascontiguousarray(mask.astype(bool), np.uint8)
    h, w = image.shape
    out = np.zeros((h, w), np.int32)
    lib.watershed(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        markers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def label_components(mask: np.ndarray) -> np.ndarray:
    """4-connected component labeling via the native kernel."""
    from ark_tpu import native
    lib = native.get_lib()
    mask = np.ascontiguousarray(mask.astype(bool), np.uint8)
    h, w = mask.shape
    out = np.zeros((h, w), np.int32)
    n = ctypes.c_int32(0)
    lib.label_components(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.byref(n))
    return out


# ---------------------------------------------------------------------------
# Device watershed (see module docstring for the algorithm and its parity
# contract with the native kernel).
# ---------------------------------------------------------------------------

_LAB_SENTINEL = np.int32(2 ** 31 - 1)

def _quantize(image, mask, levels: int):
    """Per-image quantization of `image` to int32 buckets [0, levels),
    using the same hot-pixel-robust range as the native kernel: the
    0.1%/99.9% order statistics of the MASKED values (outliers saturate
    into the end buckets). image, mask: (B, H, W); returns int32 q."""
    from ark_tpu.ops.quantiles import masked_order_stats

    b, h, w = image.shape
    n = h * w
    x = image.reshape(b, n).T.astype(jnp.float32)          # (n, B) columns
    valid = mask.reshape(b, n).T
    nv = jnp.sum(valid, axis=0).astype(jnp.int32)          # (B,)
    lo_k = nv // 1000                                      # C++: size/1000
    hi_k = jnp.maximum(nv - 1 - lo_k, 0)
    stats = masked_order_stats(x, valid, jnp.stack([lo_k, hi_k], axis=1))
    vmin, vmax = stats[:, 0], stats[:, 1]                  # (B,)
    rng = vmax - vmin
    ok = (nv > 0) & (rng > 0)
    scale = jnp.where(ok, (levels - 1) / jnp.where(rng > 0, rng, 1.0), 0.0)
    q = jnp.floor((image - vmin[:, None, None]) * scale[:, None, None])
    return jnp.clip(q, 0, levels - 1).astype(jnp.int32)


def _claim_round(lab, q, mask, level):
    """One synchronous claim: every unlabeled masked pixel adjacent to a
    source (labeled, q <= level) takes the min source label among its
    4-neighbors."""
    b, h, w = lab.shape
    src = (lab > 0) & (q <= level)
    v = jnp.where(src, lab, _LAB_SENTINEL)
    p = jnp.pad(v, ((0, 0), (1, 1), (1, 1)), constant_values=_LAB_SENTINEL)
    cand = jnp.minimum(jnp.minimum(p[:, :h, 1:w + 1], p[:, 2:, 1:w + 1]),
                       jnp.minimum(p[:, 1:h + 1, :w], p[:, 1:h + 1, 2:]))
    return jnp.where((lab == 0) & mask & (cand < _LAB_SENTINEL), cand, lab)


def _resolve_level(lab, rep, q, mask, level):
    """Finish a level exactly (phase B): conductive-component CC, min
    source label per component, one frontier claim round. Returns
    (lab, rep, sv_converged).

    `rep` is the conductive-component forest CARRIED ACROSS LEVELS: the
    conductive set {mask & q <= l} only grows with l, so a fixpoint forest
    from an earlier level stays a valid Shiloach–Vishkin starting state
    (every pointer still names a same-component pixel with a smaller-or-
    equal index; components only ever merge). Seeding from it means each
    invocation only pays for the NEW pixels/adjacencies since the forest
    was last touched — a from-scratch CC per level measured 52 s for a
    4-FOV 512² tie-heavy flood (256 levels × ~40 scatter/gather rounds);
    the incremental forest leaves only the 1-3 genuinely-active rounds."""
    b, h, w = lab.shape
    n = h * w
    conductive = mask & (q <= level)
    iota = jnp.arange(n, dtype=jnp.int32).reshape(1, h, w)
    rep_init = jnp.where(conductive & (rep == n),
                         jnp.broadcast_to(iota, lab.shape), rep)
    rep, done = cc._cc_rounds_batched(conductive, rep_init, 1,
                                      cc._budget(n))
    src_lab = jnp.where((lab > 0) & conductive, lab,
                        _LAB_SENTINEL).reshape(b, n)
    # 1-D segment_min with offset ids (the 2-D batched-scatter trap;
    # see ops/cc.py _cc_rounds_batched)
    ids = (rep.reshape(b, n)
           + (jnp.arange(b, dtype=jnp.int32) * (n + 1))[:, None]).ravel()
    table = jax.ops.segment_min(src_lab.ravel(), ids,
                                num_segments=b * (n + 1))
    got = jnp.take(table, ids).reshape(b, h, w)
    lab = jnp.where(conductive & (lab == 0) & (got < _LAB_SENTINEL),
                    got, lab)
    return _claim_round(lab, q, mask, level), rep, done


# ---------------------------------------------------------------------------
# Minimax-relaxation flood (r4). The level-scan above serializes
# 256 levels x >=2 rounds each (>=512 dependent steps — PERF.md: the
# flood floor is scan-round latency, scaling with AREA at fixed marker
# density because every level pays its rounds). This engine computes the
# same claim sets as ONE value iteration on the minimax recurrence
#
#   v(p) = min over 4-neighbors u of max(v(u), q(u)),   v(marker) = 0
#
# with (value, label) packed into a single int32 key
# (value << label_bits | label), so each round is: label-preserving lift
# of every key to its own height, 4-neighbor shifted MIN, monotone
# min-update. The iteration converges in O(max optimal-path hop count)
# rounds ~ basin radius — independent of the level count — and the
# fixpoint is EXACT minimax by the standard Bellman argument. Labels ride
# the packed keys; by induction every candidate key (val, lab) satisfies
# f(lab, p) <= val (achievability), so at the fixpoint every pixel holds
# a CO-OPTIMAL marker — the same tie concession the level engine's
# phase B makes, verified by the same Dijkstra oracle
# (tests/ops/test_watershed_device.py). Coverage is exact: v < INF iff
# the pixel is mask-reachable from a marker.
#
# Rounds run in blocks of unconditional steps with one changed-reduce +
# cond per BLOCK (a per-round cond/reduce would rebuild the very
# serialization this removes); the returned flag certifies convergence
# and `watershed_batch_np` falls back to the native flood when it is
# ever False (winding-corridor relief needing > h+w hops).
# ---------------------------------------------------------------------------

_MINIMAX_BLOCK = 16   # unconditional rounds per convergence check


def _label_bits(levels: int) -> int:
    # one extra value bucket (= `levels`) is reserved as the sweep's
    # absorbing "blocked by mask" gate, see _minimax_sweep
    return 31 - max(int(np.ceil(np.log2(levels + 1))), 1)


def _minimax_round(pk, qs, labm, claimable):
    """One relaxation round on packed keys. `qs` is q pre-shifted into the
    value bits; INT32_MAX (INF) needs no special case: its value bits are
    all-ones so the lift keeps it, and it loses every min."""
    b, h, w = pk.shape
    lifted = jnp.where(pk >= qs, pk, qs | (pk & labm))
    p = jnp.pad(lifted, ((0, 0), (1, 1), (1, 1)),
                constant_values=_LAB_SENTINEL)
    cand = jnp.minimum(jnp.minimum(p[:, :h, 1:w + 1], p[:, 2:, 1:w + 1]),
                       jnp.minimum(p[:, 1:h + 1, :w], p[:, 1:h + 1, 2:]))
    return jnp.where(claimable, jnp.minimum(pk, cand), pk)


def _minimax_sweep(pk, qs, labm, claimable, absorb):
    """Fast-sweeping acceleration: four directional `associative_scan`s
    propagate keys across the WHOLE image along straight lines in
    O(log W) stages each, so winding optimal paths cost rounds ~ the
    number of direction CHANGES instead of total hop count. The segment
    transfer function f(s) = min(c, lift_g(s)) composes in closed form:
    (c1,g1) ⊕ (c2,g2) = (min(c2, lift_{g2}(c1)), max(g1,g2)). With the
    label-preserving lift the operator is not strictly associative on
    equal-value ties, but every composed key remains ACHIEVABLE (a real
    path value carrying a marker that reaches the pixel at <= that
    value), which is the only invariant correctness needs — the
    convergence certificate comes from a no-change NEIGHBOR round, whose
    fixpoint is the exact minimax value regardless of which valid
    candidates the sweeps injected.

    Mask blocking: a line segment crossing a non-mask pixel must NOT pass
    keys through it — non-mask positions gate with the reserved `absorb`
    level (= `levels`, above every real bucket), and any swept key lifted
    that high is sanitized back to INF before the min-update."""

    def comb(a, b):
        c1, g1 = a
        c2, g2 = b
        lifted = jnp.where(c1 >= g2, c1, g2 | (c1 & labm))
        return jnp.minimum(c2, lifted), jnp.maximum(g1, g2)

    qs_gate = jnp.where(claimable | (pk <= labm), qs, absorb)

    def one_dir(pk, axis, reverse):
        flip = (slice(None),) * axis + (slice(None, None, -1),)
        p = pk[flip] if reverse else pk
        g = qs_gate[flip] if reverse else qs_gate
        # gate entering position j from j-1 is q at j-1; the first
        # position gets the absorbing gate (no predecessor)
        gate = jnp.concatenate(
            [jnp.full_like(jax.lax.slice_in_dim(g, 0, 1, axis=axis),
                           absorb),
             jax.lax.slice_in_dim(g, 0, g.shape[axis] - 1, axis=axis)],
            axis=axis)
        out, _ = jax.lax.associative_scan(comb, (p, gate), axis=axis)
        out = jnp.where(out >= absorb, _LAB_SENTINEL, out)
        return out[flip] if reverse else out

    for axis, reverse in ((2, False), (2, True), (1, False), (1, True)):
        cand = one_dir(pk, axis, reverse)
        pk = jnp.where(claimable, jnp.minimum(pk, cand), pk)
    return pk


def _refine_round(newlab, pk, qs, lb, labm, claimable):
    """One synchronous BFS re-labeling round over OPTIMAL edges: an
    unclaimed pixel p takes the min label among already-relabeled
    4-neighbors u whose exit value max(v(u), q(u)) equals v(p). BFS order
    reproduces the host flood's FIFO-within-bucket tie splitting (the
    packed minimax fixpoint alone hands contested equal-value plateaus to
    the lowest label — measured 0.91 agreement on touching EDT basins vs
    0.99+ with this pass)."""
    b, h, w = newlab.shape
    lifted = jnp.where(pk >= qs, pk, qs | (pk & labm))
    exitv = lifted >> lb                       # value a neighbor hands over
    valp = pk >> lb
    lab_ok = jnp.where(newlab > 0, newlab, _LAB_SENTINEL)

    def shift(x, fill):
        return jnp.pad(x, ((0, 0), (1, 1), (1, 1)), constant_values=fill)

    ev = shift(exitv, _LAB_SENTINEL >> lb)
    lv = shift(lab_ok, _LAB_SENTINEL)
    cand = _LAB_SENTINEL
    for sl in ((slice(None, h), slice(1, w + 1)),
               (slice(2, None), slice(1, w + 1)),
               (slice(1, h + 1), slice(None, w)),
               (slice(1, h + 1), slice(2, None))):
        m = ev[:, sl[0], sl[1]] == valp
        cand = jnp.minimum(cand, jnp.where(m, lv[:, sl[0], sl[1]],
                                           _LAB_SENTINEL))
    take = claimable & (newlab == 0) & (pk != _LAB_SENTINEL) \
        & (cand < _LAB_SENTINEL)
    return jnp.where(take, cand, newlab)


@functools.partial(jax.jit, static_argnames=("levels", "rounds"))
def _flood_minimax(q, markers, mask, levels: int, rounds: int):
    """Minimax flood on pre-quantized q; returns (labels, converged)."""
    lb = _label_bits(levels)
    labm = jnp.int32((1 << lb) - 1)
    lab0 = jnp.where((markers > 0) & mask, markers.astype(jnp.int32), 0)
    # markers hold (0, lab) and are frozen; everything else starts INF
    pk0 = jnp.where(lab0 > 0, lab0, _LAB_SENTINEL)
    claimable = mask & (lab0 == 0)
    qs = (q.astype(jnp.int32) << lb)
    absorb = jnp.int32(levels) << lb
    # mix q's shard_map varying-ness into the carry (cc._varying_false)
    pk0 = pk0 + qs * jnp.int32(0)

    n_blocks = -(-rounds // _MINIMAX_BLOCK)

    def block(carry, _):
        pk, done = carry

        def active(pk):
            pk = _minimax_sweep(pk, qs, labm, claimable, absorb)

            def one(pk, _):
                return _minimax_round(pk, qs, labm, claimable), None
            new, _ = jax.lax.scan(one, pk, None, length=_MINIMAX_BLOCK)
            # certificate: one more NEIGHBOR round changes nothing (the
            # 4-neighbor fixpoint is exact minimax; sweeps don't certify)
            probe = _minimax_round(new, qs, labm, claimable)
            return probe, jnp.all(probe == new)

        pk, done = jax.lax.cond(
            done, lambda p: (p, cc._varying_true(p)), active, pk)
        return (pk, done), None

    (pk, done), _ = jax.lax.scan(block, (pk0, cc._varying_false(pk0)),
                                 None, length=n_blocks)

    # BFS tie-refinement over optimal edges (see _refine_round): values
    # are exact now; ownership is re-derived in geodesic order
    def refine_block(carry, _):
        newlab, rdone = carry

        def active(newlab):
            def one(nl, _):
                return _refine_round(nl, pk, qs, lb, labm, claimable), None
            new, _ = jax.lax.scan(one, newlab, None,
                                  length=_MINIMAX_BLOCK)
            return new, jnp.all(new == newlab)

        newlab, rdone = jax.lax.cond(
            rdone, lambda p: (p, cc._varying_true(p)), active, newlab)
        return (newlab, rdone), None

    (newlab, rdone), _ = jax.lax.scan(
        refine_block, (lab0 + qs * jnp.int32(0), cc._varying_false(pk0)),
        None, length=n_blocks)
    lab = jnp.where(pk == _LAB_SENTINEL, 0, newlab)
    # labels must fit the packed key's label field; an overflow folds into
    # the convergence flag so callers take their certified fallback path
    # (never observed: 2^22 markers at levels=256)
    fits = jnp.max(lab0) <= labm
    return lab.astype(jnp.int32), done & rdone & fits


# engine selector for same-process A/Bs; 'minimax' is the default,
# 'levels' keeps the level-scan available
_ENGINE = "minimax"


def flood(q, markers, mask, levels: int, bfs_rounds: int):
    """Engine-dispatched device flood on pre-quantized q — the traceable
    entry point fused pipelines call (Mesmer's device postprocess).
    `bfs_rounds` applies to the level engine only; the minimax engine
    budgets by geometry (2(h+w) rounds). Read of `_ENGINE` is bake-at-
    trace: callers toggling it for an A/B must clear jit caches."""
    if _ENGINE == "minimax":
        b, h, w = q.shape
        return _flood_minimax(q, markers, mask, levels, rounds=2 * (h + w))
    return _flood(q, markers, mask, levels, bfs_rounds)


@functools.partial(jax.jit, static_argnames=("levels", "bfs_rounds"))
def _quantize_and_flood(image, markers, mask, levels: int,
                        bfs_rounds: int):
    """The full device watershed as ONE jitted program (quantization
    included — eagerly it is ~a dozen separate dispatches)."""
    q = _quantize(image.astype(jnp.float32), mask, levels)
    # budget note: optimal-path hop counts exceed h+w only on adversarial
    # winding relief (random-noise plateaus); 2(h+w) covered every case
    # tried, and non-convergence is certified via the flag
    return flood(q, markers, mask, levels, bfs_rounds)


@functools.partial(jax.jit, static_argnames=("levels", "bfs_rounds"))
def _flood(q, markers, mask, levels: int, bfs_rounds: int):
    lab0 = jnp.where((markers > 0) & mask, markers.astype(jnp.int32), 0)
    # mix q's shard_map varying-ness into the scan carries: markers/mask
    # may be unvarying constants built inside a shard while the claim
    # rounds (functions of q) are varying (see quantiles.masked_order_stats)
    lab0 = lab0 + q * jnp.int32(0)
    n = lab0.shape[1] * lab0.shape[2]
    rep0 = lab0 * 0 + jnp.int32(n)    # full_like, but varying like lab0

    def level_body(carry, level):
        lab, rep = carry

        def bfs_round(carry, _):
            lab, done = carry

            def active(lab):
                new = _claim_round(lab, q, mask, level)
                return new, jnp.all(new == lab)

            lab, done = jax.lax.cond(
                done, lambda l: (l, cc._varying_true(l)), active, lab)
            return (lab, done), None

        (lab, a_done), _ = jax.lax.scan(bfs_round,
                                        (lab, cc._varying_false(lab)),
                                        None, length=bfs_rounds)
        lab, rep, sv_done = jax.lax.cond(
            a_done, lambda a: (a[0], a[1], cc._varying_true(a[0])),
            lambda a: _resolve_level(a[0], a[1], q, mask, level),
            (lab, rep))
        return (lab, rep), sv_done

    (lab, _), sv_dones = jax.lax.scan(level_body, (lab0, rep0),
                                      jnp.arange(levels, dtype=jnp.int32))
    return lab, jnp.all(sv_dones)


def watershed_device(image, markers, mask=None, levels: int = 256,
                     bfs_rounds: int = 32):
    """Batched marker watershed on device (see module docstring).

    image: (B, H, W) or (H, W) float — flooded ascending (same convention
    as `watershed`); markers: int labels, same shape; mask: optional bool.
    Returns (labels int32 (same shape), converged bool scalar) as DEVICE
    arrays — jittable/fusable into surrounding device pipelines. `levels`
    trades claim-level resolution (the native kernel uses 2^16 buckets)
    against the length of the level scan; at 256 the quantized claim
    ordering of smooth relief (Mesmer inner-distances, EDT basins) is
    preserved and the scan stays short.
    """
    image = jnp.asarray(image)
    single = image.ndim == 2
    if single:
        image, markers = image[None], jnp.asarray(markers)[None]
        mask = None if mask is None else jnp.asarray(mask)[None]
    markers = jnp.asarray(markers).astype(jnp.int32)
    mask = jnp.ones(image.shape, bool) if mask is None \
        else jnp.asarray(mask).astype(bool)
    lab, done = _quantize_and_flood(image, markers, mask, levels,
                                    bfs_rounds)
    return (lab[0], done) if single else (lab, done)


def watershed_batch_np(image: np.ndarray, markers: np.ndarray,
                       mask: np.ndarray = None, levels: int = 256,
                       bfs_rounds: int = 32) -> np.ndarray:
    """Host wrapper over `watershed_device` for (B, H, W) stacks: numpy in,
    numpy out, one device dispatch. If the internal SV budget ever fails to
    converge (never observed; tested by shrinking the budget), falls back
    to the native per-image flood rather than returning an uncertified
    result."""
    lab, done = watershed_device(image, markers, mask, levels=levels,
                                 bfs_rounds=bfs_rounds)
    if not bool(done):  # pragma: no cover - backstop, exercised via mock
        mask = np.ones(image.shape, bool) if mask is None else mask
        return np.stack([watershed(image[i], markers[i], mask[i])
                         for i in range(image.shape[0])])
    return np.array(lab)
