"""SWT — Stroke Width Transform (Epshtein et al., CVPR'08).

Ref: src/pillowfight/swt.c pf_swt (a port of CCV/DetectText) — SURVEY.md
§2.2/§3.3. The reference walks rays with pointer arithmetic, qsorts each
ray for the median clamp, and merges connected components sequentially.

Re-design (everything static-shaped, jit-safe, batched over pages).
Random-access gathers and scatters cost far more per element than dense
page sweeps, so the ray machinery is reformulated to be *dense and
shift-based*:

1. Edge map + gradients come from the shared canny/sobel/gaussian stack.
2. Ray directions are quantized to 16 primitive integer vectors
   (SWT_N_DIRS; axis, diagonal and knight moves, max error ~13 deg vs the
   reference's continuous march — well inside the pi/6 opposing-gradient
   tolerance). A ray of class k visits multiples of v_k (plus the
   intermediate cell for knight moves, so 1-px canny edge lines cannot be
   jumped).
3. First-edge distance for EVERY pixel along every class is computed by
   pointer doubling over static shifts: log2(T) dense select passes per
   class carry (euclidean distance, class-at-first-edge, plus optional
   payloads pulled from the first-edge cell). One set of 16 chains
   serves both polarity passes (a dark-on-light ray of class k is a
   light-on-dark ray of class k+8).
4. Stroke widths are committed WITHOUT ray marching, by the segment
   identity: a class-k ray stops at the first edge, so the cells a ray
   covers are exactly one edge-free run between two edge pixels — which
   means the ONLY anchor that can commit to a pixel p along class k is
   p's nearest upstream edge e1, its hit is p's nearest downstream edge
   e2, and the stroke width is dist(e1, p) + dist(p, e2). Both come from
   the first-edge chains of k and k+8, so the whole commit is O(1) dense
   selects per class — no while_loop, no t_cap, no dynamic rolls.
5. The per-ray median clamp gathers an evenly-subsampled 17-point
   profile per compacted valid ray (the only gather in the kernel),
   sorts once, writes medians back to their unique anchor pixels, and
   re-commits them through a second payload-carrying first-edge chain
   (the median rides the same upstream pull as the width).
6. Connected components over similar stroke widths use
   morph.label_components_links; per-component statistics compact the
   valid-SWT pixels first so the scatter-adds touch ~1/8 of the page.

Outputs (enum parity with the reference):
  SWT_OUTPUT_BW_TEXT         0: detected letter pixels black on white
  SWT_OUTPUT_GRAYSCALE_TEXT  1: letter pixels keep their gray value on white
  SWT_OUTPUT_ORIGINAL_BOXES  2: original page + letter bounding boxes
"""

from __future__ import annotations

import operator
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import constants as C
from ..core.bitmap import (
    ensure_batched,
    maybe_unbatch,
    pages_to_words,
    words_to_gray,
    words_to_pages,
)
from .canny import canny_edge_mask_from_gradients, canny_gradients
from .morph import label_components_links

# plain float, not jnp.float32: a module-level jnp scalar would
# initialize the XLA backend at import time, which breaks
# jax.distributed.initialize (it must run before backend init)
_INF = 1e9

# 16 primitive direction vectors (dy, dx), ordered by angle; class k + 8
# is the opposite direction. Knight moves carry an intermediate cell
# (the rounded half-step) so digital rays cannot jump a 1-px edge line.
_VECS = (
    (0, 1), (1, 2), (1, 1), (2, 1),
    (1, 0), (2, -1), (1, -1), (1, -2),
    (0, -1), (-1, -2), (-1, -1), (-2, -1),
    (-1, 0), (-2, 1), (-1, 1), (-1, 2),
)
_NDIR = len(_VECS)
_ANGLES = np.arctan2([v[0] for v in _VECS], [v[1] for v in _VECS])
_NORMS = np.hypot([v[0] for v in _VECS], [v[1] for v in _VECS])


def _half(v):
    """Intermediate cell of one v-step (knight moves only), else None."""
    w = (int(np.round(v[0] / 2.0)), int(np.round(v[1] / 2.0)))
    return w if w != (0, 0) and w != v else None


def _shift_static(x: jax.Array, dy: int, dx: int, fill) -> jax.Array:
    """out[y, x] = x[y + dy, x + dx], `fill` outside. x is [H, W]."""
    h, w = x.shape
    py, px = abs(dy), abs(dx)
    p = jnp.pad(x, ((py, py), (px, px)), constant_values=fill)
    return p[py + dy : py + dy + h, px + dx : px + dx + w]


def _quantize_dirs(ux: jax.Array, uy: jax.Array) -> jax.Array:
    """Nearest primitive-vector class (int8) for unit directions."""
    ang = jnp.arctan2(uy, ux)  # [-pi, pi]
    # distance on the circle to each class angle
    diffs = jnp.abs(
        jnp.mod(ang[..., None] - jnp.asarray(_ANGLES, jnp.float32) + np.pi,
                2 * np.pi) - np.pi
    )
    return jnp.argmin(diffs, axis=-1).astype(jnp.int8)


def _halves(v):
    """Intermediate cells of one v-step (knight moves), ordered far to
    near so overwriting base-case hits leaves the NEAREST one. A digital
    ray is blocked by an edge on EITHER intermediate (symmetric in the
    travel direction, so upstream and downstream chains agree)."""
    h = _half(v)
    if h is None:
        return ()
    g = (v[0] - h[0], v[1] - h[1])
    pair = sorted({h, g}, key=lambda c: -np.hypot(*c))
    return tuple(pair)


def _first_edge_along(edge_cls: jax.Array, k: int, t_units: int,
                      payloads=()):
    """First edge pixel along direction class k from every pixel.

    edge_cls int8 [H,W]: class id at edge pixels, -1 elsewhere. Checks
    the intermediate half-step cells first for knight vectors (a digital
    ray must not pass through a 1-px edge). Pointer doubling: after step
    j the carry holds the first edge within 2^j v-steps, so log2(t_units)
    static-shift select passes compute every pixel's first hit.

    payloads: optional f32 [H,W] maps; their value AT the first-edge
    cell is pulled back to every pixel (fill _INF on miss) — this is how
    the median clamp rides the chain back over the ray cells.

    Returns (enc int32 [H,W] — the packed chain state, decode with
    _decode_chain into (dist, units, class-at-hit, lat) where lat=False
    marks a hit at a knight intermediate: such an edge blocks the ray
    but lies on a NEIGHBOR line, so it cannot anchor a ray through this
    pixel — [pulled payloads...]).
    """
    v = _VECS[k]
    halves = _halves(v)

    # ENCODED carry: the whole chain state packs into ONE int32 plane —
    # u (bits 0..10, v-step count, <= 2*t_units << 2047), hit class c
    # (bits 11..15; 16 = miss), lat flag (bit 16), knight-half index
    # (bit 17). One shifted plane per doubling step instead of the 4-5
    # separate (d, u, c, lat) planes of the unpacked formulation, and
    # the step-count update is a single integer add (the u field sits in
    # the low bits and never carries out: u <= 2 * t_units <= 256).
    # Distances decode on demand (_decode_chain): d = u*|v| for lattice
    # hits, (u-1)*|v| + |half| for knight-intermediate hits.
    i32 = jnp.int32

    # one-step base case: full step first, then intermediates far->near
    # overwrite (the continuously-first hit wins)
    ev = _shift_static(edge_cls, v[0], v[1], -1).astype(i32)
    enc = jnp.where(ev >= 0, 1 | (ev << 11) | (1 << 16), _CHAIN_MISS)
    pl = [jnp.where(ev >= 0, _shift_static(p, v[0], v[1], _INF), _INF)
          for p in payloads]
    for idx, hc in enumerate(halves):
        eh = _shift_static(edge_cls, hc[0], hc[1], -1).astype(i32)
        hit_h = eh >= 0
        enc = jnp.where(hit_h, 1 | (eh << 11) | (idx << 17), enc)
        pl = [jnp.where(hit_h, _shift_static(p, hc[0], hc[1], _INF), q)
              for p, q in zip(payloads, pl)]

    step = 1
    while step < t_units:
        sy, sx = step * v[0], step * v[1]
        enc2 = _shift_static(enc, sy, sx, _CHAIN_MISS)
        take = (((enc >> 11) & 31) == 16) & (((enc2 >> 11) & 31) != 16)
        enc = jnp.where(take, enc2 + step, enc)
        pl = [jnp.where(take, _shift_static(q, sy, sx, _INF), q) for q in pl]
        step *= 2
    return (enc, *pl)


_CHAIN_MISS = (16 << 11) | 2047


def _decode_chain(enc: jax.Array, k: int):
    """Unpack an encoded first-edge chain plane -> (d f32, u i32, c i32,
    lat bool); INF / -1 / False on miss. Pure elementwise ALU — fuses
    into the commit selects."""
    v = _VECS[k]
    nv = float(_NORMS[k])
    halves = _halves(v)
    u = enc & 2047
    c5 = (enc >> 11) & 31
    hit = c5 < 16
    lat = ((enc >> 16) & 1) == 1
    uf = u.astype(jnp.float32)
    if halves:
        h0 = float(np.hypot(*halves[0]))
        h1 = float(np.hypot(*halves[1])) if len(halves) > 1 else h0
        hsel = jnp.where(((enc >> 17) & 1) == 1, jnp.float32(h1),
                         jnp.float32(h0))
        d = jnp.where(lat, uf * nv, (uf - 1.0) * nv + hsel)
    else:
        d = uf * nv
    d = jnp.where(hit, d, _INF)
    c = jnp.where(hit, c5, -1)
    return d, u, c, lat & hit


_MED_SAMPLES = 13  # ray cells 0..12 sampled for the median clamp (rays
                   # of <= 13 cells get the exact per-cell median)


def _class_commit(k: int, s: int, down, up, edge_cls, is_edge, t_units,
                  opposing, payload_up=None, payload_anchor=None):
    """Committed value map for (class k, sign s) via the segment pull.

    down/up = (d, u, c) chains along k and k+8. A pixel p's only class-k
    committer is its nearest upstream edge e1 (u chain); the hit is its
    nearest downstream edge e2 (d chain); both ends' validity conditions
    are re-derived from the chain carries. With payload_up (the value
    pulled from e1, e.g. the ray median) the committed value is that
    payload instead of the geometric width; payload_anchor is the value
    an anchor pixel commits to itself.

    Returns (contrib f32 [H,W], is_anchor bool, u_dn i32) — contrib
    already includes knight-move intermediate coverage.
    """
    d_dn, u_dn, c_dn = down[0], down[1], down[2]
    d_up, u_up, c_up, lat_up = up[0], up[1], up[2], up[3]
    # an edge of gradient class c casts along class c (sign +1) or c+8
    # (sign -1). The Epshtein condition compares the HIT gradient against
    # the ANCHOR's gradient class `src` (~anti-parallel) — ref: swt.c.
    src = (k - (_NDIR // 2 if s == -1 else 0)) % _NDIR
    # e1 is a src-class edge ON THIS LATTICE LINE (an edge at a knight
    # intermediate blocks rays but anchors only its own neighbor line —
    # that coverage arrives via the half-cell shift below)
    anchor_up_ok = (c_up == src) & lat_up
    hit_dn_ok = opposing(c_dn, src)       # e2 opposes the anchor

    # mid cells: the edge-free run (e1, e2) is e1's ray. (d < _INF
    # guards are implied: anchor_up_ok/hit_dn_ok already require a hit
    # class >= 0, and misses decode to c = -1.)
    mid_ok = (
        (~is_edge) & anchor_up_ok & hit_dn_ok
        & (u_up + u_dn <= t_units)
    )
    # hit cells: p == e2 of e1's ray (rays include their hit pixel)
    hit_ok = (
        is_edge & anchor_up_ok & opposing(edge_cls, src)
        & (u_up <= t_units)
    )
    # anchor cells: p == e1 (rays cover their own anchor)
    is_anchor = (
        (edge_cls == src) & hit_dn_ok & (u_dn <= t_units)
    )
    if payload_up is None:
        w_mid = jnp.where(mid_ok, jnp.maximum(d_up + d_dn, 1.0), _INF)
        w_hit = jnp.where(hit_ok, jnp.maximum(d_up, 1.0), _INF)
        w_anc = jnp.where(is_anchor, jnp.maximum(d_dn, 1.0), _INF)
    else:
        w_mid = jnp.where(mid_ok, payload_up, _INF)
        w_hit = jnp.where(hit_ok, payload_up, _INF)
        w_anc = (jnp.where(is_anchor, payload_anchor, _INF)
                 if payload_anchor is not None else _INF)

    contrib = jnp.minimum(jnp.minimum(w_mid, w_hit), w_anc)
    half = _half(_VECS[k])
    if half is not None:
        # knight rays also cover the half-step cell after every covered
        # non-hit cell m: intermediate c = m + half pulls from m
        w_prev = jnp.minimum(w_mid, w_anc)
        contrib = jnp.minimum(
            contrib, _shift_static(w_prev, -half[0], -half[1], _INF))
    return contrib, is_anchor, u_dn


def _swt_maps_one(gray, edges, gx, gy, max_len):
    """Both polarities' stroke-width maps for one page.

    gx/gy are the gaussian-smoothed sobel gradients SHARED with the
    canny edge stack (canny.canny_gradients — recomputing them here
    cost a duplicate gaussian+sobel pass).

    Returns (swt_minus, swt_plus) f32 [H,W] (_INF = no stroke):
    sign=-1 marches against the gradient (into dark strokes,
    dark-on-light text), sign=+1 along it (light-on-dark).
    """
    h, w = gray.shape
    norm = jnp.maximum(jnp.sqrt(gx * gx + gy * gy), 1e-6)
    ux, uy = gx / norm, gy / norm

    cls = _quantize_dirs(ux, uy)                   # gradient class, int8
    edge_cls = jnp.where(edges, cls, jnp.int8(-1))
    is_edge = edge_cls >= 0

    # opposing-gradient test on classes: within pi/6 of anti-parallel.
    # class angular spacing alternates 18.4/26.6 deg, so +-1 class of the
    # opposite direction covers the tolerance.
    def opposing(hit_cls, k):
        diff = jnp.mod(hit_cls.astype(jnp.int32) - (k + _NDIR // 2), _NDIR)
        return (hit_cls >= 0) & ((diff <= 1) | (diff >= _NDIR - 1))

    def t_units(k):
        return max(int(np.ceil(max_len / _NORMS[k])), 1)

    swt = {s: jnp.full((h, w), _INF, jnp.float32) for s in (-1, 1)}
    # anchor state packed into ONE i32 plane per sign: bits 0..10 = ray
    # units (u <= 2047 by the chain encoding), bits 11..15 = class,
    # bit 16 = is-anchor — one accumulator update per commit instead of
    # three (saves ~2 full-plane read+writes x 32 commits)
    a_enc = {s: jnp.zeros((h, w), jnp.int32) for s in (-1, 1)}

    # ---- pass 1: width maps. Chains come in opposite pairs so only two
    # are live at a time (memory: O(1) page maps, not O(classes)).
    for k in range(_NDIR // 2):
        (enc_k,) = _first_edge_along(edge_cls, k, t_units(k))
        (enc_o,) = _first_edge_along(edge_cls, k + _NDIR // 2, t_units(k))
        dec_k = _decode_chain(enc_k, k)
        dec_o = _decode_chain(enc_o, k + _NDIR // 2)
        for kk, down, up in ((k, dec_k, dec_o), (k + _NDIR // 2, dec_o, dec_k)):
            for s in (-1, 1):
                contrib, is_anchor, u_dn = _class_commit(
                    kk, s, down, up, edge_cls, is_edge, t_units(kk), opposing)
                swt[s] = jnp.minimum(swt[s], contrib)
                a_enc[s] = jnp.where(
                    is_anchor, u_dn | (kk << 11) | (1 << 16), a_enc[s])
    any_anchor = {s: (a_enc[s] >> 16) != 0 for s in (-1, 1)}
    a_units = {s: a_enc[s] & 2047 for s in (-1, 1)}
    a_k = {s: (a_enc[s] >> 11) & 31 for s in (-1, 1)}

    # ---- median clamp (pass 2, ref: swt.c / Epshtein sec. 3.1): per
    # valid ray, the median of its stroke-width cells, re-committed
    # along the same segment via a payload-carrying chain.
    #
    # FULLY DENSE, no compaction: the earlier gather formulation paid
    # for a page-scale jnp.nonzero plus a [17, R] random gather PER
    # SIGN. Here sample j of an anchor's ray
    # is swt[anchor + j*v_k] for FIXED offsets j = 0.._MED_SAMPLES-1 —
    # a per-class dense shift selected per pixel by the anchor's class
    # plane, valid while j <= u (inside the ray). For rays of u+1 <=
    # _MED_SAMPLES cells this is the EXACT per-cell median the
    # reference's qsort computes (vals[n/2], upper median — oracle.cc
    # pf swt pass 2), closer than the old 17-point evenly-subsampled
    # profile; longer rays use the prefix cells (golden-pinned). No
    # capacity cap exists — nothing can truncate.
    n_anchors = jnp.sum((any_anchor[-1] | any_anchor[1]).astype(jnp.int32))
    med_map = {}
    for s in (-1, 1):
        u_pl = a_units[s]
        k_pl = a_k[s]
        samples = []
        for j in range(_MED_SAMPLES):
            if j == 0:
                sj = swt[s]
            else:
                # one select_n over the 16 class-shifted planes (a
                # 16-way where-chain re-reads the accumulator 16x)
                sj = jax.lax.select_n(
                    k_pl, *[_shift_static(swt[s], j * _VECS[k][0],
                                          j * _VECS[k][1], _INF)
                            for k in range(_NDIR)])
            samples.append(jnp.where(j <= u_pl, sj, _INF))
        vals = jnp.sort(jnp.stack(samples, 0), axis=0)  # [M, H, W]
        cnt = jnp.minimum(u_pl + 1, _MED_SAMPLES)
        mid = cnt // 2  # upper median, matching the oracle's vals[n/2]
        med = jnp.full((h, w), _INF, jnp.float32)
        for j in range(_MED_SAMPLES):
            med = jnp.where(mid == j, vals[j], med)
        med_map[s] = jnp.where(any_anchor[s], med, _INF)

    # clamp covers the anchor itself; ray cells get the median through a
    # second chain that pulls med_map from the upstream anchor (both
    # signs' payloads ride one chain pair per class)
    res = {s: jnp.minimum(swt[s], med_map[s]) for s in (-1, 1)}
    for k in range(_NDIR // 2):
        pls = (med_map[-1], med_map[1])
        ch_k = _first_edge_along(edge_cls, k, t_units(k), payloads=pls)
        ch_o = _first_edge_along(edge_cls, k + _NDIR // 2, t_units(k),
                                 payloads=pls)
        dec_k = _decode_chain(ch_k[0], k)
        dec_o = _decode_chain(ch_o[0], k + _NDIR // 2)
        for kk, down, up, up_pl in ((k, dec_k, dec_o, ch_o[1:]),
                                    (k + _NDIR // 2, dec_o, dec_k, ch_k[1:])):
            for si, s in enumerate((-1, 1)):
                contrib, _, _ = _class_commit(
                    kk, s, down, up, edge_cls, is_edge, t_units(kk), opposing,
                    payload_up=up_pl[si], payload_anchor=med_map[s])
                res[s] = jnp.minimum(res[s], contrib)
    return res[-1], res[1], n_anchors


# --------------------------------------------------------------------------
# letter components
# --------------------------------------------------------------------------

def _seg_chain(lab, payloads, ops, reverse=False, max_span=None):
    """Per-element inclusive segmented reductions along the LAST axis of
    a label array (elements with equal `lab` in a contiguous range form
    a segment), by pointer doubling: after step 2^j each element has
    reduced over all same-label elements within 2^j positions (toward
    index 0, or toward the end with reverse=True). Same-label tests are
    plain shifted compares — no gathers, no scatters, and sums stay
    segment-local (full-array prefix-sum differencing would lose f32
    precision at page scale).

    payloads: list of arrays shaped like lab; ops: matching binary
    reduction callables (jnp.minimum/jnp.maximum/operator.add).
    max_span bounds the doubling (segments are guaranteed shorter).

    Segment membership is CONTIGUOUS same-label reach, carried as an
    AND-chained adjacency flag (adj at step s means every element in
    the s-span shares the label), not a raw label compare at distance
    s — a raw compare would let a component with two same-label runs in
    one row (U/H/O shapes) absorb the far run across the background gap
    whenever a power-of-two step bridges it.
    """
    n = lab.shape[-1] if max_span is None else min(max_span, lab.shape[-1])
    big = jnp.int32(-1) if not reverse else jnp.int32(-2)

    def shift(x, s, fill):
        pad = jnp.full(x.shape[:-1] + (s,), fill, x.dtype)
        if reverse:
            return jnp.concatenate([x[..., s:], pad], axis=-1)
        return jnp.concatenate([pad, x[..., :-s]], axis=-1)

    out = list(payloads)
    adj = shift(lab, 1, big) == lab  # contiguous same-label at distance 1
    s = 1
    while s < n:
        for i, op in enumerate(ops):
            cand = shift(out[i], s, 0)
            out[i] = jnp.where(adj, op(out[i], cand), out[i])
        adj = adj & shift(adj, s, False)
        s *= 2
    return out


def _median_gray(gray):
    """Exact jnp.median of a gray plane [B,H,W] whose values are k/3 for
    integer k in 0..765 (words_to_gray output), via histogram binary
    search — ~10 fused compare+reduce sweeps instead of a full-page sort.
    Returns [B] f32, bit-identical to jnp.median's arithmetic."""
    b, h, w = gray.shape
    s3 = jnp.round(gray * 3.0).astype(jnp.int32)
    ntot = h * w

    def count_le(t):
        return jnp.sum((s3 <= t[:, None, None]).astype(jnp.int32),
                       axis=(1, 2))

    def kth(k):  # smallest value v with count_le(v) >= k (1-based rank)
        lo = jnp.zeros((b,), jnp.int32)
        hi = jnp.full((b,), 765, jnp.int32)
        for _ in range(10):  # 2^10 > 766
            mid = (lo + hi) // 2
            ge = count_le(mid) >= k
            hi = jnp.where(ge, mid, hi)
            lo = jnp.where(ge, lo, mid + 1)
        return hi

    if ntot % 2:
        return kth((ntot + 1) // 2).astype(jnp.float32) / 3.0
    a = kth(ntot // 2).astype(jnp.float32) / 3.0
    c = kth(ntot // 2 + 1).astype(jnp.float32) / 3.0
    return (a + c) / 2.0


def _letter_mask_one(gray, swt_minus, swt_plus, med, max_letters, max_runs):
    """Filter SWT components down to letter candidates for ONE page —
    both polarity passes in one labeling + one statistics sweep.

    Returns (mask bool [H,W], boxes int32 [max_letters, 4] as
    (y0, y1, x0, x1), boxes_ok bool [max_letters]) — the boxes are the
    accepted letter components' bounding boxes (ref: swt.c renders one
    box per accepted letter in PF_SWT_OUTPUT_ORIGINAL_BOXES mode; the
    C++ oracle pf_oracle_swt draws the same set).

    Polarity consistency gate (shared spec extension with the oracle):
    the dark-on-light pass only keeps pixels darker than the page median
    (strokes are dark), the light-on-dark pass only pixels lighter —
    this rejects the page-spanning pseudo strokes that inter-letter
    gaps / blank pages produce. The two gated pixel sets are therefore
    DISJOINT, so both passes share one combined SWT plane; CC links add
    a same-polarity condition, making each component single-polarity.

    Statistics design — ROW-RUN aggregation. Earlier formulations used
    per-pixel scatter-adds or a full-page sort to group pixels by
    label; both walk every pixel irregularly. Here every maximal same-label
    row run pre-aggregates its pixels with dense segmented doubling
    chains along rows (runs are <= a stroke crossing wide, so the
    chains stop at 2^9), runs compact through one nonzero (~#stroke
    crossings, not #pixels), per-component statistics reduce over runs
    with run-count-sized scatters into flat-index tables, and the
    accepted-component decision paints back through the same runs — no
    page-scale sorts, gathers, or scatters anywhere.
    """
    h, w = swt_minus.shape
    neg = gray < med
    pos = gray > med
    swt = jnp.where(neg, swt_minus, jnp.where(pos, swt_plus, _INF))
    valid = swt < _INF

    # pairwise links: neighbors whose stroke-width ratio <= SWT_CC_SW_RATIO
    # and (combined-pass invariant) equal polarity
    def link(dy, dx):
        rolled = jnp.roll(jnp.roll(swt, -dy, 0), -dx, 1)
        nvalid = jnp.roll(jnp.roll(valid, -dy, 0), -dx, 1)
        npol = jnp.roll(jnp.roll(neg, -dy, 0), -dx, 1)
        ratio_ok = (
            (jnp.maximum(swt, rolled) / jnp.maximum(jnp.minimum(swt, rolled), 1e-6))
            <= C.SWT_CC_SW_RATIO
        )
        ok = valid & nvalid & ratio_ok & (neg == npol)
        # kill wrap-around links
        ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        ok = ok & (ys + dy < h) & (ys + dy >= 0) & (xs + dx < w) & (xs + dx >= 0)
        return ok

    links = {d: link(*d)[None] for d in ((0, 1), (1, 0), (1, 1), (1, -1))}
    labels = label_components_links(valid[None], links)[0]  # [H,W], bg = h*w

    # ---- row runs: maximal same-label runs along each row. The run
    # start holds the whole run's aggregates after one reverse
    # (rightward-inclusive) segmented chain along the row.
    n = h * w
    lab = jnp.where(valid, labels, n)
    lab_left = jnp.concatenate(
        [jnp.full((h, 1), n, lab.dtype), lab[:, :-1]], axis=1)
    run_start = valid & (lab != lab_left)

    ones = valid.astype(jnp.float32)
    swt_v = jnp.where(valid, swt, 0.0)
    r_cnt, r_s1, r_s2 = _seg_chain(
        lab, [ones, swt_v, swt_v * swt_v],
        [operator.add, operator.add, operator.add], reverse=True)

    # ---- compact runs (the only page-scale irregular op). Sort-based:
    # flat indices of run starts ascend, n pads the tail — identical
    # row-major order to jnp.nonzero without nonzero's internal
    # scatter over every pixel
    n_runs = jnp.sum(run_start.astype(jnp.int32))
    flat_idx = jax.lax.sort(
        jnp.where(run_start.reshape(-1), jax.lax.iota(jnp.int32, n),
                  jnp.int32(n)), is_stable=False)[:max_runs]
    r_ok = flat_idx < n
    rys = jnp.minimum(flat_idx // w, h - 1)
    rxs = jnp.where(r_ok, flat_idx - rys * w, 0)
    r_lab = jnp.where(r_ok, lab[rys, rxs], n)
    cnt_r = jnp.where(r_ok, r_cnt[rys, rxs], 0.0)
    s1_r = jnp.where(r_ok, r_s1[rys, rxs], 0.0)
    s2_r = jnp.where(r_ok, r_s2[rys, rxs], 0.0)
    yf = rys.astype(jnp.float32)
    x0f = rxs.astype(jnp.float32)
    x1f = x0f + cnt_r - 1.0  # run is contiguous: xmax = xstart + len - 1

    # ---- per-component statistics in SORTED-SEGMENT form. The earlier
    # formulation scattered 7 per-run values into flat-label-indexed
    # [H*W+1] tables and gathered decisions back — 8 R-sized scatters +
    # gathers. Here ONE stable multi-payload sort
    # groups runs by label; per-component reductions become segmented
    # doubling scans over the sorted 1-D array (cheap [R] vector ops),
    # decisions broadcast back through the segment, and the only
    # remaining page-scale irregulars are the keep-paint scatter and a
    # tiny rejected-rep table.
    nb = n + 1
    r_lab_s, cnt_s, s1_s, s2_s, yf_s, x0f_s, x1f_s, flat_s = jax.lax.sort(
        (r_lab, cnt_r, s1_r, s2_r, yf, x0f, x1f, flat_idx),
        dimension=0, num_keys=1, is_stable=True)
    # stable + input ascending by flat index => each label segment's
    # FIRST element is the component's min-flat-index run (the rep,
    # whose flat index IS the label)
    lab2 = r_lab_s[None]
    (cnt_t, s1_t, s2_t) = _seg_chain(
        lab2, [cnt_s[None], s1_s[None], s2_s[None]],
        [operator.add, operator.add, operator.add], reverse=True)
    (ymin_t, xmin_t) = _seg_chain(
        lab2, [yf_s[None], x0f_s[None]], [jnp.minimum, jnp.minimum],
        reverse=True)
    (ymax_t, xmax_t) = _seg_chain(
        lab2, [yf_s[None], x1f_s[None]], [jnp.maximum, jnp.maximum],
        reverse=True)
    cnt_t, s1_t, s2_t, ymin_t, xmin_t, ymax_t, xmax_t = (
        a[0] for a in (cnt_t, s1_t, s2_t, ymin_t, xmin_t, ymax_t, xmax_t))

    start = r_lab_s != jnp.concatenate(
        [jnp.full((1,), -1, r_lab_s.dtype), r_lab_s[:-1]])
    r_ok_s = r_lab_s < n

    nn = jnp.maximum(cnt_t, 1.0)
    mean_sw = s1_t / nn
    var_sw = jnp.maximum(s2_t / nn - mean_sw * mean_sw, 0.0)
    bw = xmax_t - xmin_t + 1.0
    bh = ymax_t - ymin_t + 1.0
    diag = jnp.sqrt(bw * bw + bh * bh)
    aspect = jnp.maximum(bw, bh) / jnp.maximum(jnp.minimum(bw, bh), 1.0)
    ok_seg = (
        (cnt_t >= C.SWT_LETTER_MIN_PIXELS)
        & (var_sw <= C.SWT_LETTER_VARIANCE_RATIO * mean_sw * mean_sw)
        & (aspect <= C.SWT_LETTER_ASPECT_RATIO_MAX)
        & (diag < C.SWT_LETTER_DIAMETER_SW_RATIO * jnp.maximum(mean_sw, 1e-6))
        & (bh >= C.SWT_LETTER_HEIGHT_MIN)
        & (bh <= C.SWT_LETTER_HEIGHT_MAX)
        & start & r_ok_s
    )
    n_letters = jnp.sum(ok_seg.astype(jnp.int32))

    # ---- nested-box filter: a component containing > SWT_MAX_NESTED_LETTERS
    # other accepted boxes is a frame, not a letter (ref: swt.c).
    # Compact the accepted reps' boxes with one small sort.
    rep_key = jnp.where(ok_seg, r_lab_s, n)
    rep_idx, b_y0, b_y1, b_x0, b_x1 = jax.lax.sort(
        (rep_key, ymin_t, ymax_t, xmin_t, xmax_t),
        dimension=0, num_keys=1, is_stable=False)
    rep_idx = rep_idx[:max_letters]
    ry0 = b_y0[:max_letters].astype(jnp.int32)
    ry1 = b_y1[:max_letters].astype(jnp.int32)
    rx0 = b_x0[:max_letters].astype(jnp.int32)
    rx1 = b_x1[:max_letters].astype(jnp.int32)
    l_ok = rep_idx < n
    # nesting is counted within a polarity pass (the oracle runs the
    # nested filter per swt_polarity call): a rep's polarity is its
    # representative pixel's (the label IS its min flat pixel index)
    r_neg = neg.reshape(-1)[jnp.minimum(rep_idx, n - 1)]
    contains = (
        (ry0[:, None] <= ry0[None, :]) & (ry1[:, None] >= ry1[None, :])
        & (rx0[:, None] <= rx0[None, :]) & (rx1[:, None] >= rx1[None, :])
        & (r_neg[:, None] == r_neg[None, :])
        & l_ok[:, None] & l_ok[None, :]
        & ~jnp.eye(max_letters, dtype=bool)
    )
    nested = jnp.sum(contains, axis=1)
    rejected = l_ok & (nested > C.SWT_MAX_NESTED_LETTERS)
    rej_tab = jnp.zeros(nb, bool).at[
        jnp.where(rejected, rep_idx, n)].set(True)
    rej_tab = rej_tab.at[n].set(False)

    # ---- paint acceptance back: broadcast the segment-start decision
    # forward through the segment, drop rejected components, scatter the
    # kept runs' start pixels (sorted order carries flat_s, so no
    # unsort), then a rightward segmented OR along rows (dense)
    (ok_bcast,) = _seg_chain(
        lab2, [ok_seg[None].astype(jnp.float32)], [jnp.maximum])
    keep_s = r_ok_s & (ok_bcast[0] > 0.5) & ~rej_tab[r_lab_s]
    keep_plane = jnp.zeros(nb, jnp.float32).at[
        jnp.where(keep_s, flat_s, n)
    ].max(jnp.where(keep_s, 1.0, 0.0), mode="drop")[:n].reshape(h, w)
    (keep_f,) = _seg_chain(lab, [keep_plane], [jnp.maximum])
    mask = valid & (keep_f > 0.5)

    boxes = jnp.stack([ry0, ry1, rx0, rx1], axis=-1).astype(jnp.int32)
    boxes_ok = l_ok & ~rejected
    return mask, boxes, boxes_ok, n_runs, n_letters


def _letter_mask(gray, swt_minus, swt_plus, max_letters, max_runs):
    """Batched letter pass: per-page core under lax.map (sequential per
    page — the per-page program lowers exactly like the unbatched one;
    a vmap batches the irregular ops into larger sorts and scatters)."""
    med = _median_gray(gray)

    def one(args):
        g, sm, sp, m = args
        return _letter_mask_one(g, sm, sp, m, max_letters, max_runs)

    return jax.lax.map(one, (gray, swt_minus, swt_plus, med))




# --------------------------------------------------------------------------
# public op
# --------------------------------------------------------------------------

def _boxes_on_mask(boxes, boxes_ok, h, w):
    """Box-perimeter mask bool [B,H,W] from boxes int32 [B,N,4] =
    (y0, y1, x0, x1) and boxes_ok bool [B,N]. One cheap fori_loop
    iteration per candidate slot (pure elementwise compares, no materialized
    [N,H,W] tensor). Ref: swt.c PF_SWT_OUTPUT_ORIGINAL_BOXES."""
    b = boxes.shape[0]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)[None]
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)[None]

    def body(i, on):
        y0 = boxes[:, i, 0][:, None, None]
        y1 = boxes[:, i, 1][:, None, None]
        x0 = boxes[:, i, 2][:, None, None]
        x1 = boxes[:, i, 3][:, None, None]
        per = (
            (((ys == y0) | (ys == y1)) & (xs >= x0) & (xs <= x1))
            | (((xs == x0) | (xs == x1)) & (ys >= y0) & (ys <= y1))
        )
        return on | (per & boxes_ok[:, i][:, None, None])

    return jax.lax.fori_loop(
        0, boxes.shape[1], body, jnp.zeros((b, h, w), bool))


def _gray_word(v, alpha):
    """Replicate a uint32 byte value v into the RGB bytes of a word."""
    return alpha | v | (v << jnp.uint32(8)) | (v << jnp.uint32(16))


@partial(jax.jit, static_argnames=(
    "output_type", "max_rays", "max_len", "max_letters", "max_runs",
    "max_valid", "max_edges", "return_debug"))
def swt(
    pages: jax.Array,
    output_type: int = C.SWT_OUTPUT_BW_TEXT,
    max_rays: int | None = None,
    max_len: int = C.SWT_MAX_RAY_LEN,
    max_letters: int | None = None,
    max_runs: int | None = None,
    max_edges: int | None = None,  # legacy alias for max_rays
    max_valid: int | None = None,  # legacy alias for max_runs sizing
    return_debug: bool = False,
):
    """Stroke Width Transform. uint8 RGBA [B,H,W,4] or uint32 words
    [B,H,W] (or single page) in; same form out.

    max_rays is DEPRECATED and ignored: the median clamp is dense
    (per-class static shifts selected by the anchor-class plane), so
    there is no compacted ray list and nothing to truncate. max_len
    bounds ray length in pixels (<= 1023: the encoded
    chain packs the v-step count into 11 bits); max_runs bounds the
    compacted row-run list for component statistics (default H*W//16 —
    a run is a maximal same-component span in one row, so the bound is
    on stroke CROSSINGS, not pixels; shared by both polarity passes,
    whose gated pixel sets are disjoint); max_letters bounds the
    nested-box candidate list (default scales with page area,
    max(1024, H*W//2048) ~= 4x the densest real text page; total across
    both polarities — nesting itself is counted per polarity, matching
    the oracle's per-pass filter).

    return_debug=True also returns a dict of per-page int32 counts
    {"n_anchors", "n_runs", "n_letters"} plus the static caps — no cap
    may silently truncate: assert n_x <= max_x to audit a run.
    """
    if max_len > 1023:
        raise ValueError(
            f"max_len={max_len} exceeds 1023: the encoded first-edge "
            "chain packs the v-step count into bits 0..10 (u <= 2047, "
            "u reaches 2*t_units), so longer rays would carry into the "
            "class bits and corrupt every chain decode")
    pages, unb = ensure_batched(pages)
    in_words = pages.dtype == jnp.uint32
    words = pages if in_words else pages_to_words(pages)
    gray = words_to_gray(words)
    _, h, w = gray.shape
    if max_rays is None:
        max_rays = max_edges if max_edges is not None else max(h * w // 8, 1024)
    if max_runs is None:
        # runs = stroke crossings: the dense A4 golden (1,500 letters)
        # measures 72k vs h*w//32 = 272k — 3.8x headroom, and
        # return_debug audits the cap. Every irregular op in the letter
        # pass (scatters, gathers, sorts) scales with this bound.
        max_runs = (max_valid if max_valid is not None
                    else max(h * w // 32, 1024))
    if max_letters is None:
        max_letters = max(h * w // 2048, 1024)

    ggx, ggy = canny_gradients(gray)
    edges = canny_edge_mask_from_gradients(ggx, ggy)
    # the maps are per-page shift chains (vmap costs nothing there —
    # measured); the letter pass is natively batched (vmap cost 5x)
    swt_minus, swt_plus, n_anchors = jax.vmap(
        lambda g, e, x, y: _swt_maps_one(g, e, x, y, max_len))(
            gray, edges, ggx, ggy)
    letter, boxes, boxes_ok, n_runs, n_letters = _letter_mask(
        gray, swt_minus, swt_plus, max_letters, max_runs)

    u = jnp.uint32
    alpha = words & u(0xFF000000)
    if output_type == C.SWT_OUTPUT_BW_TEXT:
        v = jnp.where(letter, u(C.PF_BLACK), u(C.PF_WHITE))
        out = _gray_word(v, alpha)
    elif output_type == C.SWT_OUTPUT_GRAYSCALE_TEXT:
        g8 = jnp.clip(jnp.round(gray), 0, 255).astype(u)
        v = jnp.where(letter, g8, u(C.PF_WHITE))
        out = _gray_word(v, alpha)
    elif output_type == C.SWT_OUTPUT_ORIGINAL_BOXES:
        on_box = _boxes_on_mask(boxes, boxes_ok, h, w)
        out = jnp.where(on_box, alpha | u(0x000000FF), words)  # red
    else:
        raise ValueError(f"unknown swt output_type {output_type}")
    if not in_words:
        out = words_to_pages(out)
    out = maybe_unbatch(out, unb)
    if return_debug:
        return out, {
            # n_anchors is informational: the dense median has no cap
            "n_anchors": n_anchors,
            "n_runs": n_runs, "max_runs": max_runs,
            "n_letters": n_letters, "max_letters": max_letters,
        }
    return out
