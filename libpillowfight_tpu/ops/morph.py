"""Data-parallel morphology: reachability + connected components.

Data-parallel replacement for the reference's irregular, pointer-chasing code:
canny hysteresis BFS (ref: src/pillowfight/canny.c), blackfilter /
noisefilter flood fills (ref: blackfilter.c, noisefilter.c), and SWT's
connected-component pass (ref: swt.c) — SURVEY.md §3.2-§3.4.

Re-design: flood fill becomes a *fixed-point iteration* that converges in
very few rounds because each round combines
  (a) segmented associative scans along rows and columns — these propagate
      information across an entire run of connected pixels in O(log n)
      depth (lax.associative_scan), i.e. a whole straight segment floods
      in ONE round, and
  (b) one gated 8-neighbor dilation — which lets the flood turn corners
      and cross diagonal links.
The number of rounds needed is the number of "turns" in the most winding
connected path (tiny for scanned documents), not the path length, and a
`lax.while_loop` on a change-detector makes the result exact.

All functions are batched over pages ([B, H, W]) and jit-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# --------------------------------------------------------------------------
# neighborhood maxima (gated dilation)
# --------------------------------------------------------------------------

def _window_reduce(x: jax.Array, init, op, window) -> jax.Array:
    if x.dtype == jnp.bool_:
        y = jax.lax.reduce_window(
            x.astype(jnp.float32), float(init), op, window, (1, 1, 1), "SAME"
        )
        return y > 0
    return jax.lax.reduce_window(x, x.dtype.type(init), op, window, (1, 1, 1), "SAME")


def dilate8(x: jax.Array) -> jax.Array:
    """3x3 max (8-neighborhood) of bool/int/f32 [B,H,W], min-identity padded."""
    lo = 0 if x.dtype == jnp.bool_ else (
        jnp.iinfo(x.dtype).min if jnp.issubdtype(x.dtype, jnp.integer) else -jnp.inf
    )
    return _window_reduce(x, lo, jax.lax.max, (1, 3, 3))


def dilate4(x: jax.Array) -> jax.Array:
    """Plus-shaped (4-neighborhood) max."""
    lo = 0 if x.dtype == jnp.bool_ else (
        jnp.iinfo(x.dtype).min if jnp.issubdtype(x.dtype, jnp.integer) else -jnp.inf
    )
    h = _window_reduce(x, lo, jax.lax.max, (1, 1, 3))
    v = _window_reduce(x, lo, jax.lax.max, (1, 3, 1))
    return h | v if x.dtype == jnp.bool_ else jnp.maximum(h, v)


def dilate_cheb(x: jax.Array, k: int) -> jax.Array:
    """Chebyshev-ball dilation of radius k. bool [B,H,W]. k=1 is the
    plain 8-neighborhood dilation. Separable AND idempotent, so each
    axis is an O(log k) doubling chain of pad-shifts rather than a
    (2k+1)-tap reduce_window (41 taps/px at the blackfilter default)."""
    if k == 1:
        return dilate8(x)
    for axis in (-2, -1):
        covered = 0
        while covered < k:
            s = min(max(covered, 1), k - covered)
            x = x | _shift1(x, s, axis, False) | _shift1(x, -s, axis, False)
            covered += s
        # covered-interval union: [-c..c] | shift±s -> [-(c+s)..c+s]
    return x


def erode_min8(x: jax.Array, big) -> jax.Array:
    """3x3 min (8-neighborhood) of int32 [B,H,W], `big`-padded."""
    return _window_reduce(x, big, jax.lax.min, (1, 3, 3))


def erode_min4(x: jax.Array, big) -> jax.Array:
    h = _window_reduce(x, big, jax.lax.min, (1, 1, 3))
    v = _window_reduce(x, big, jax.lax.min, (1, 3, 1))
    return jnp.minimum(h, v)


# --------------------------------------------------------------------------
# segmented scans (the workhorse)
# --------------------------------------------------------------------------

def _shift1(x: jax.Array, d: int, axis: int, fill) -> jax.Array:
    """out[..., i, ...] = x[..., i - d, ...] along axis, `fill` outside."""
    pad = [(0, 0)] * x.ndim
    idx = [slice(None)] * x.ndim
    if d > 0:
        pad[axis] = (d, 0)
        idx[axis] = slice(0, x.shape[axis])
    else:
        pad[axis] = (0, -d)
        idx[axis] = slice(-d, x.shape[axis] - d)
    return jnp.pad(x, pad, constant_values=fill)[tuple(idx)]


def _seg_or_scan_1d(mask: jax.Array, value: jax.Array, axis: int) -> jax.Array:
    """Segmented OR: value[i] |= any value in i's contiguous mask-run, along axis.

    Formulated as prefix sums instead of a tuple-carrier associative_scan
    (two cumsums and two cummaxes per axis). With cs = prefix count of seeds and E = cs at the run start, "any seed
    in [start..i]" is cs[i] - E > 0; E is recovered scan-free as
    cummax(where(run_start, cs - seed, -1)) because cs is nondecreasing,
    so the max over starts <= i IS the value at the latest start."""
    ax = axis % mask.ndim
    seed = (value & mask).astype(jnp.float32)
    cs = jnp.cumsum(seed, axis=ax)
    start = mask & ~_shift1(mask, 1, ax, False)
    base = jax.lax.cummax(jnp.where(start, cs - seed, -1.0), axis=ax)
    fwd = cs - base > 0.5
    csr = jax.lax.cumsum(seed, axis=ax, reverse=True)
    end = mask & ~_shift1(mask, -1, ax, False)
    baser = jax.lax.cummax(jnp.where(end, csr - seed, -1.0), axis=ax,
                           reverse=True)
    rev = csr - baser > 0.5
    return (fwd | rev) & mask


def _seg_min_doubling(values: jax.Array, linked_next: jax.Array, axis: int,
                      big) -> jax.Array:
    """Per-element min over its maximal linked run along `axis`.

    linked_next[..., i, ...] means elements i and i+1 belong to the same
    run. Pointer-doubling formulation: with E = prefix count of gaps, the
    span [i-d, i] is gap-free iff E[i] == E[i-d], so each of the log2(n)
    steps is two shifted compare+min pairs — plain elementwise ops
    instead of a tuple-carrier associative_scan (the int32 cumsum runs
    once)."""
    ax = axis % values.ndim
    n = values.shape[ax]
    gaps = jnp.cumsum((~linked_next).astype(jnp.int32), axis=ax)
    e = _shift1(gaps, 1, ax, 0)  # gaps strictly before element i
    v = values
    d = 1
    while d < n:
        vm = _shift1(v, d, ax, big)
        em = _shift1(e, d, ax, -1)
        v = jnp.minimum(v, jnp.where(e == em, vm, big))
        vp = _shift1(v, -d, ax, big)
        ep = _shift1(e, -d, ax, -1)
        v = jnp.minimum(v, jnp.where(ep == e, vp, big))
        d *= 2
    return v


def _seg_min_scan_1d(mask: jax.Array, label: jax.Array, axis: int, big: int) -> jax.Array:
    """Segmented MIN: label[i] = min label over i's contiguous mask-run, along axis."""
    ax = axis % mask.ndim
    linked = mask & _shift1(mask, -1, ax, False)
    out = _seg_min_doubling(jnp.where(mask, label, big), linked, ax, big)
    return jnp.where(mask, out, label)


# --------------------------------------------------------------------------
# reachability (hysteresis / flood fill)
# --------------------------------------------------------------------------

def _flood_fixed_point(seeds: jax.Array, mask: jax.Array, connectivity: int,
                       max_iters: int, leap: int = 1) -> jax.Array:
    """Plain fixed point: (row-scan, col-scan, gated dilation) rounds.

    leap > 1 (8-conn only) widens the dilation to a Chebyshev ball of
    radius `leap`: the flood jumps gaps of up to `leap` pixels between
    mask pixels (unpaper's blackfilter flood intensity — larger values
    leap larger gaps). The segmented scans stay on strict runs (a sound
    subset); the wide dilation supplies the jumps."""
    if leap > 1:
        dil = lambda r: dilate_cheb(r, leap)
    else:
        dil = dilate8 if connectivity == 8 else dilate4

    def round_(r):
        r = _seg_or_scan_1d(mask, r, axis=-1)
        r = _seg_or_scan_1d(mask, r, axis=-2)
        r = (dil(r) & mask) | r
        return r

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        r, _, it = state
        r2 = round_(r)
        return r2, jnp.any(r2 != r), it + 1

    with jax.named_scope("flood_fixed_point"):
        r, _, _ = jax.lax.while_loop(
            cond, body, (round_(seeds), jnp.bool_(True), 1))
    return r


_COARSE = 4  # multigrid coarsening factor


def flood_reach(seeds: jax.Array, mask: jax.Array, connectivity: int = 8,
                max_iters: int | None = None, leap: int = 1) -> jax.Array:
    """All mask pixels connected (4/8-conn) to a seed. bool [B,H,W] each.

    max_iters=None (the default) iterates to the TRUE fixed point: the
    round cap is set to H*W + 2, a guaranteed upper bound because each
    round counted as "changed" strictly grows the reach set, so the
    convergence detector always fires first. The result is exact for
    every input — no winding-path geometry can silently under-flood.
    Pass a finite max_iters only to trade exactness for a latency bound.

    leap > 1 (8-conn only): two mask pixels within Chebyshev distance
    `leap` are considered connected — the flood leaps gaps, matching
    unpaper's blackfilter flood intensity semantics (only mask pixels
    are ever filled; gap pixels act as bridges, not fill targets).

    Exact fixed point, accelerated by one multigrid level: the mask is
    coarsened conservatively (a coarse cell is mask iff its CxC block is
    ALL mask, so coarse connectivity implies full-res connectivity), the
    flood runs on the 16x-smaller grid first, and its upsampled result
    seeds the full-resolution fixed point. Solid regions (black scan
    borders — the expensive blackfilter case) converge at the coarse
    level; the full-res loop only refines boundaries, so it needs a
    couple of rounds instead of O(region diameter / scan reach).
    Sound: coarse reach is a subset of true reach (all-mask blocks at
    coarse Chebyshev distance d hold pixels at distance (d-1)*C+1, so a
    coarse leap of (leap-1)//C + 1 never connects blocks whose nearest
    pixels exceed `leap`), and the final full-res fixed point is exact
    regardless of the starting subset.
    """
    assert leap == 1 or connectivity == 8, "leap requires 8-connectivity"
    mask = mask.astype(bool)
    seeds = seeds.astype(bool) & mask

    b, h, w = mask.shape
    if max_iters is None:
        max_iters = h * w + 2
    c = _COARSE
    if h >= 4 * c and w >= 4 * c:
        ph, pw = -h % c, -w % c
        mp = jnp.pad(mask, ((0, 0), (0, ph), (0, pw)))
        sp = jnp.pad(seeds, ((0, 0), (0, ph), (0, pw)))
        hc, wc = (h + ph) // c, (w + pw) // c
        blocks_all = mp.reshape(b, hc, c, wc, c).all(axis=(2, 4))
        seeds_any = sp.reshape(b, hc, c, wc, c).any(axis=(2, 4))
        r_c = _flood_fixed_point(seeds_any & blocks_all, blocks_all,
                                 connectivity, max_iters,
                                 leap=(leap - 1) // c + 1)
        up = jnp.repeat(jnp.repeat(r_c, c, axis=1), c, axis=2)[:, :h, :w]
        seeds = seeds | (up & mask)
    return _flood_fixed_point(seeds, mask, connectivity, max_iters, leap=leap)


# --------------------------------------------------------------------------
# connected-component labeling
# --------------------------------------------------------------------------

def label_components(mask: jax.Array, connectivity: int = 8,
                     max_iters: int | None = None) -> jax.Array:
    """CC labels for bool [B,H,W]: int32 [B,H,W], label = min flat index in
    the component; background = H*W (one past the largest valid label).

    max_iters=None (default) iterates to the true fixed point (cap
    H*W + 2, see flood_reach — min-label propagation is simultaneous
    flood from each component's min pixel, so the same bound applies)."""
    mask = mask.astype(bool)
    b, h, w = mask.shape
    if max_iters is None:
        max_iters = h * w + 2
    big = h * w
    idx = (
        jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 1) * w
        + jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 2)
    )
    labels = jnp.where(mask, idx, big)

    erode = erode_min8 if connectivity == 8 else erode_min4

    def round_(l):
        l = _seg_min_scan_1d(mask, l, axis=-1, big=big)
        l = _seg_min_scan_1d(mask, l, axis=-2, big=big)
        l = jnp.where(mask, jnp.minimum(l, erode(jnp.where(mask, l, big), big)), big)
        return l

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        l, _, it = state
        l2 = round_(l)
        return l2, jnp.any(l2 != l), it + 1

    labels, _, _ = jax.lax.while_loop(cond, body, (round_(labels), jnp.bool_(True), 1))
    return labels


def _shift2d(x: jax.Array, dy: int, dx: int, fill) -> jax.Array:
    """out[y, x] = x_in[y+dy, x+dx], `fill` outside. x is [B,H,W]."""
    b, h, w = x.shape
    py, px = abs(dy), abs(dx)
    p = jnp.pad(x, ((0, 0), (py, py), (px, px)), constant_values=fill)
    return p[:, py + dy : py + dy + h, px + dx : px + dx + w]


_OFFSETS8 = ((0, 1), (1, 0), (1, 1), (1, -1))  # unique undirected directions


def label_components_links(valid: jax.Array, links: dict,
                           max_iters: int | None = None) -> jax.Array:
    """CC labeling with *pairwise* connectivity (used by SWT's similar-
    stroke-width components, ref: src/pillowfight/swt.c — SURVEY.md §3.3).

    valid: bool [B,H,W]. links: {(dy,dx): bool [B,H,W]} for the four
    undirected directions (0,1),(1,0),(1,1),(1,-1); links[d][b,y,x] means
    pixel (y,x) is connected to (y+dy,x+dx). Returns int32 labels
    (min flat index per component; background = H*W).
    """
    valid = valid.astype(bool)
    b, h, w = valid.shape
    if max_iters is None:
        max_iters = h * w + 2
    big = h * w
    idx = (
        jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 1) * w
        + jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 2)
    )
    labels0 = jnp.where(valid, idx, big)

    def axis_scan(l, conn, axis):
        """Segmented min along axis; conn[y,x] links (y,x)->(next along axis).
        conn is only set between valid pixels, so invalid cells stay
        singleton runs (keep their big label)."""
        return _seg_min_doubling(l, conn, axis, big)

    def neighbor_min(l):
        out = l
        for (dy, dx) in _OFFSETS8:
            conn = links[(dy, dx)]
            # pull label from (y+dy, x+dx)
            cand = _shift2d(l, dy, dx, big)
            out = jnp.minimum(out, jnp.where(conn, cand, big))
            # and the mirrored direction
            cand_m = _shift2d(l, -dy, -dx, big)
            conn_m = _shift2d(conn, -dy, -dx, False)
            out = jnp.minimum(out, jnp.where(conn_m, cand_m, big))
        return out

    def round_(l):
        l = axis_scan(l, links[(0, 1)], axis=2)
        l = axis_scan(l, links[(1, 0)], axis=1)
        l = jnp.where(valid, neighbor_min(l), big)
        return l

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        l, _, it = state
        l2 = round_(l)
        return l2, jnp.any(l2 != l), it + 1

    labels, _, _ = jax.lax.while_loop(
        cond, body, (round_(labels0), jnp.bool_(True), 1)
    )
    return labels


def small_cluster_mask(mask: jax.Array, k: int, connectivity: int = 8) -> jax.Array:
    """Pixels whose 8-connected cluster has <= k members. Exact, local,
    scan-free, loop-free — no global CC labeling.

    This is the data-parallel form of the reference noisefilter's per-pixel
    *bounded flood count* (ref: src/pillowfight/noisefilter.c — SURVEY.md
    §2.2): each pixel p carries a (2k+1)^2-bit bitboard of window offsets
    reachable from p within j steps through the mask; k bit-parallel
    dilation steps compute |B_k(p)| (the graph ball) exactly, and
        |cluster(p)| <= k  <=>  |B_k(p)| <= k
    (if the cluster has <= k pixels its diameter is < k, so the ball IS
    the cluster; if it has more, BFS layers stay nonempty so the ball has
    >= k+1 members). The bitboards are packed into ceil((2k+1)^2/32)
    uint32 planes, so one step is ~100 fused elementwise ops on [B,H,W] words —
    no while_loop, no segmented scans, no (2k+1)^2-shift label count.
    """
    assert connectivity == 8, "noisefilter clusters are 8-connected"
    mask = mask.astype(bool)
    s = 2 * k + 1
    nb = s * s
    nw = (nb + 31) // 32
    u32 = jnp.uint32

    # -- window-mask bitboards: bit (dy+k)*s+(dx+k) of M = mask[p+(dy,dx)]
    m_words = [jnp.zeros(mask.shape, u32) for _ in range(nw)]
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            b = (dy + k) * s + (dx + k)
            w, o = divmod(b, 32)
            m_words[w] = m_words[w] | (
                _shift2d(mask, dy, dx, False).astype(u32) << u32(o)
            )

    # -- destination-validity constants per direction: bit b is a valid
    # target of a shift by (ey,ex) iff its dx-ex stays inside the window
    # (otherwise the packed shift aliased a neighboring row) and b < nb
    def _valid_word(ex: int, w: int) -> int:
        val = 0
        for bit in range(32):
            b = w * 32 + bit
            if b >= nb:
                continue
            dx = b % s - k
            if -k <= dx - ex <= k:
                val |= 1 << bit
        return val

    dirs = [(ey, ex) for ey in (-1, 0, 1) for ex in (-1, 0, 1)
            if (ey, ex) != (0, 0)]
    valid = {
        (ey, ex): [u32(_valid_word(ex, w)) for w in range(nw)]
        for ey, ex in dirs
    }

    zero = jnp.zeros(mask.shape, u32)

    def _bit_shift(words, amt):
        """Shift the nb-bit board by `amt` bit positions (zero fill).

        amt may exceed a word (|amt| reaches 2k+2 > 32 for k >= 16):
        decompose into a whole-word offset plus a sub-word bit offset so
        no XLA shift count is ever >= 32 (shift-by-32 on uint32 is
        undefined in XLA)."""
        if amt == 0:
            return list(words)
        wo, bo = divmod(amt if amt > 0 else -amt, 32)
        out = []
        for w in range(nw):
            if amt > 0:
                src, carry = w - wo, w - wo - 1
            else:
                src, carry = w + wo, w + wo + 1
            v = zero
            if 0 <= src < nw:
                v = words[src] if bo == 0 else (
                    words[src] << u32(bo) if amt > 0 else words[src] >> u32(bo)
                )
            if bo and 0 <= carry < nw:
                v = v | (
                    words[carry] >> u32(32 - bo) if amt > 0
                    else words[carry] << u32(32 - bo)
                )
            out.append(v)
        return out

    # -- init: center bit set on mask pixels
    c = k * s + k
    cw, co = divmod(c, 32)
    r = [
        jnp.where(mask, u32(1 << co), u32(0)) if w == cw
        else jnp.zeros(mask.shape, u32)
        for w in range(nw)
    ]

    # -- k bit-parallel dilation steps (monotone: identity term included)
    for _ in range(k):
        acc = list(r)
        for (ey, ex) in dirs:
            shifted = _bit_shift(r, ey * s + ex)
            vm = valid[(ey, ex)]
            for w in range(nw):
                acc[w] = acc[w] | (shifted[w] & vm[w])
        r = [acc[w] & m_words[w] for w in range(nw)]

    size = sum(jax.lax.population_count(r[w]).astype(jnp.int32)
               for w in range(nw))
    return mask & (size <= k)


