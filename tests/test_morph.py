"""Morphology engine (flood fill / connected components) vs scipy.ndimage."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage

from libpillowfight_tpu.ops import morph

STRUCT8 = np.ones((3, 3), bool)
STRUCT4 = scipy.ndimage.generate_binary_structure(2, 1)


def _random_blobs(rng, h=48, w=64, p=0.35):
    return rng.random((h, w)) < p


def test_flood_reach_matches_scipy(rng):
    mask = _random_blobs(rng)
    seeds = np.zeros_like(mask)
    seeds[10, 10] = seeds[30, 40] = True
    seeds &= mask
    for conn, struct in ((8, STRUCT8), (4, STRUCT4)):
        got = np.asarray(
            morph.flood_reach(jnp.asarray(seeds)[None], jnp.asarray(mask)[None],
                              connectivity=conn)[0]
        )
        labels, _ = scipy.ndimage.label(mask, structure=struct)
        seed_labels = set(labels[seeds]) - {0}
        want = np.isin(labels, list(seed_labels)) if seed_labels else np.zeros_like(mask)
        np.testing.assert_array_equal(got, want)


def test_flood_reach_spiral():
    """A winding spiral path — worst case for round-count convergence."""
    h = w = 33
    mask = np.zeros((h, w), bool)
    # build a rectangular spiral
    y, x = 0, 0
    mask[0, :] = True
    mask[:, -1] = True
    mask[-1, :] = True
    mask[2:, 0] = True
    mask[2, 2 : w - 2] = True
    mask[2 : h - 2, w - 3] = True
    mask[h - 3, 2 : w - 2] = True
    seeds = np.zeros_like(mask)
    seeds[0, 0] = True
    got = np.asarray(
        morph.flood_reach(jnp.asarray(seeds)[None], jnp.asarray(mask)[None])[0]
    )
    labels, _ = scipy.ndimage.label(mask, structure=STRUCT8)
    want = labels == labels[0, 0]
    np.testing.assert_array_equal(got, want)


def test_label_components_matches_scipy(rng):
    mask = _random_blobs(rng, p=0.4)
    for conn, struct in ((8, STRUCT8), (4, STRUCT4)):
        got = np.asarray(
            morph.label_components(jnp.asarray(mask)[None], connectivity=conn)[0]
        )
        want_labels, n = scipy.ndimage.label(mask, structure=struct)
        # same partition: for every scipy component, all our labels equal
        assert np.all((got < mask.size) == mask)
        for i in range(1, n + 1):
            vals = got[want_labels == i]
            assert len(set(vals.tolist())) == 1
        # distinct scipy components get distinct labels
        reps = [got[want_labels == i].flat[0] for i in range(1, n + 1)]
        assert len(set(reps)) == n


def test_label_components_links_rows():
    """Pairwise-connectivity CC: two horizontal runs joined by one link."""
    valid = np.ones((1, 3, 8), bool)
    links = {
        (0, 1): np.zeros((1, 3, 8), bool),
        (1, 0): np.zeros((1, 3, 8), bool),
        (1, 1): np.zeros((1, 3, 8), bool),
        (1, -1): np.zeros((1, 3, 8), bool),
    }
    links[(0, 1)][0, 0, 0:3] = True   # row0: 0-1-2-3 connected
    links[(0, 1)][0, 2, 4:6] = True   # row2: 4-5-6 connected
    links[(1, 0)][0, 0, 2] = False
    got = np.asarray(
        morph.label_components_links(
            jnp.asarray(valid), {k: jnp.asarray(v) for k, v in links.items()}
        )[0]
    )
    assert len(set(got[0, 0:4].tolist())) == 1
    assert len(set(got[2, 4:7].tolist())) == 1
    assert got[0, 0] != got[2, 4]
    # now join them with a diagonal link chain via (1,0) at column 3
    links[(1, 0)][0, 0, 3] = True
    links[(1, 0)][0, 1, 3] = True
    links[(0, 1)][0, 2, 3] = True
    got = np.asarray(
        morph.label_components_links(
            jnp.asarray(valid), {k: jnp.asarray(v) for k, v in links.items()}
        )[0]
    )
    assert got[0, 0] == got[2, 4]


def test_small_cluster_mask_matches_scipy(rng):
    """Bit-parallel bounded ball size vs exact scipy component sizes."""
    for trial in range(4):
        mask = rng.random((40, 56)) < (0.15 + 0.15 * trial)
        labels, n = scipy.ndimage.label(mask, structure=STRUCT8)
        sizes = np.bincount(labels.ravel(), minlength=n + 1)
        for k in (1, 2, 4, 6):
            got = np.asarray(
                morph.small_cluster_mask(jnp.asarray(mask)[None], k)[0]
            )
            want = mask & (sizes[labels] <= k)
            np.testing.assert_array_equal(got, want, err_msg=f"k={k} t={trial}")


def test_small_cluster_mask_large_k(rng):
    """k >= 15 exercises multi-word bitboard shifts (shift amounts 2k+2
    exceed one 32-bit word; regression test for the single-word-carry
    _bit_shift)."""
    mask = rng.random((48, 64)) < 0.12
    labels, n = scipy.ndimage.label(mask, structure=STRUCT8)
    sizes = np.bincount(labels.ravel(), minlength=n + 1)
    for k in (15, 16, 20):
        got = np.asarray(morph.small_cluster_mask(jnp.asarray(mask)[None], k)[0])
        want = mask & (sizes[labels] <= k)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


def test_small_cluster_mask_exact_boundary():
    """Clusters of exactly k and k+1 pixels straddle the threshold."""
    mask = np.zeros((16, 32), bool)
    mask[2, 2:6] = True          # 4-pixel line
    mask[8, 2:7] = True          # 5-pixel line
    mask[2, 20] = True           # singleton
    mask[10:12, 20:22] = True    # 2x2 square (4 px, diagonal-connected)
    got = np.asarray(morph.small_cluster_mask(jnp.asarray(mask)[None], 4)[0])
    want = mask.copy()
    want[8, 2:7] = False         # the only cluster with > 4 pixels survives
    np.testing.assert_array_equal(got, ~np.logical_xor(got, want) & got)
    np.testing.assert_array_equal(got, want)


def test_flood_reach_leap():
    """Gap-leap connectivity: mask pixels within Chebyshev distance
    `leap` are connected; wider gaps are not (unpaper blackfilter
    intensity semantics). Gap pixels are never filled."""
    h, w = 60, 200
    mask = np.zeros((h, w), bool)
    mask[20:30, 10:60] = True     # region A (seeded)
    mask[20:30, 75:110] = True    # region B: 15px gap  (<= leap 20)
    mask[20:30, 140:180] = True   # region C: 30px gap from B (> leap 20)
    seeds = np.zeros_like(mask)
    seeds[25, 15] = True
    got = np.asarray(
        morph.flood_reach(jnp.asarray(seeds)[None], jnp.asarray(mask)[None],
                          connectivity=8, leap=20)[0])
    assert got[20:30, 10:60].all()
    assert got[20:30, 75:110].all(), "15px gap should be leapt (leap=20)"
    assert not got[20:30, 140:180].any(), "30px gap must NOT be leapt"
    assert not got[~mask].any(), "gap pixels must never be filled"


def test_flood_reach_leap_diagonal_and_rows():
    """Leap works across rows (sublane axis) and diagonally."""
    h, w = 120, 80
    mask = np.zeros((h, w), bool)
    mask[10:20, 10:50] = True
    mask[32:40, 10:50] = True     # 12 rows below (<= 20)
    mask[55:60, 60:70] = True     # diagonal: dy=15, dx=10 -> cheb 15
    seeds = np.zeros_like(mask)
    seeds[15, 15] = True
    got = np.asarray(
        morph.flood_reach(jnp.asarray(seeds)[None], jnp.asarray(mask)[None],
                          connectivity=8, leap=20)[0])
    assert got[32:40, 10:50].all()
    assert got[55:60, 60:70].all()


def test_line_counts_matches_numpy(rng):
    """Row and column dark counts are plain integer sums, exact in f32."""
    from libpillowfight_tpu.ops.unpaper.common import line_counts

    mask = rng.random((2, 203, 317)) < 0.3
    rows, cols = line_counts(jnp.asarray(mask))
    assert rows.dtype == jnp.float32 and cols.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(rows), mask.sum(2))
    np.testing.assert_array_equal(np.asarray(cols), mask.sum(1))


# --------------------------------------------------------------------------
# flood / label cases at page-like shapes, against scipy
# --------------------------------------------------------------------------

def _truth_reach(seeds, mask):
    labels, _ = scipy.ndimage.label(mask, structure=STRUCT8)
    ids = set(labels[seeds & mask]) - {0}
    return np.isin(labels, list(ids)) if ids else np.zeros_like(mask)


def _truth_leap(seeds, mask, leap):
    """Leap connectivity: mask pixels within Chebyshev distance `leap`
    are connected. Ground truth by dilation to a fixed point."""
    st = np.ones((2 * leap + 1, 2 * leap + 1), bool)
    reach = (seeds & mask).copy()
    while True:
        grown = scipy.ndimage.binary_dilation(reach, st) & mask
        if (grown == reach).all():
            return reach
        reach = grown


def _spiral(h, w):
    m = np.zeros((h, w), bool)
    m[0, :] = m[:, -1] = m[-1, :] = True
    m[2:, 0] = True
    m[2, 2 : w - 2] = True
    return m


def _case_random(rng):
    mask = rng.random((2, 96, 200)) < 0.4
    seeds = np.zeros_like(mask)
    seeds[:, 10, 10] = seeds[:, 50, 150] = True
    return seeds, mask, 1


def _case_tall_column(rng):
    """A 1-px column crossing the whole page: vertical propagation in
    one run, no band or word boundary may stop it."""
    mask = np.zeros((1, 300, 140), bool)
    mask[0, :, 70] = True
    mask[0, 5, 70:100] = True
    seeds = np.zeros_like(mask)
    seeds[0, 5, 99] = True
    return seeds, mask, 1


def _case_spiral(rng):
    mask = _spiral(96, 96)[None]
    seeds = np.zeros_like(mask)
    seeds[0, 0, 0] = True
    return seeds, mask, 1


def _case_wrap_row(rng):
    """Row prefix and suffix both masked but disconnected: no wrap-around
    may bridge them."""
    mask = np.zeros((1, 64, 256), bool)
    mask[0, 30, :20] = mask[0, 30, -20:] = True
    seeds = np.zeros_like(mask)
    seeds[0, 30, 250] = True
    return seeds, mask, 1


def _case_wrap_rows_cols(rng):
    """The same for top/bottom rows vertically."""
    mask = np.zeros((1, 64, 256), bool)
    mask[0, 30, :50] = mask[0, 30, 200:] = True
    mask[0, :10, 128] = mask[0, 54:, 128] = True
    seeds = np.zeros_like(mask)
    seeds[0, 30, 5] = seeds[0, 3, 128] = True
    return seeds, mask, 1


def _case_no_seeds(rng):
    mask = rng.random((1, 40, 130)) < 0.5
    return np.zeros_like(mask), mask, 1


def _case_dense_edge_seeds(rng):
    mask = rng.random((2, 217, 133)) < 0.55
    seeds = np.zeros_like(mask)
    seeds[:, 0, :] = mask[:, 0, :]
    return seeds, mask, 1


def _case_leap_rows(rng):
    """Gap-leap radius 20 across rows, and gaps wider than the radius."""
    mask = np.zeros((1, 300, 140), bool)
    mask[0, 10:20, 10:60] = True
    mask[0, 32:40, 10:60] = True    # 12-row gap, leapt
    mask[0, 150:160, 10:60] = True  # far region, NOT leapt
    mask[0, 34:36, 100:130] = True  # dx gap 40 from col 60: > 20, not leapt
    seeds = np.zeros_like(mask)
    seeds[0, 15, 15] = True
    return seeds, mask, 20


def _leap_case(leap):
    def case(rng):
        mask = np.zeros((1, 80, 160), bool)
        mask[0, 10:14, 5:40] = True
        mask[0, 10:14, 40 + leap : 90] = True      # gap of exactly `leap`
        mask[0, 14 + leap : 40, 60:64] = True      # vertical continuation
        mask[0, 70:75, 120:150] = True             # far island
        seeds = np.zeros_like(mask)
        seeds[0, 11, 6] = True
        return seeds, mask, leap
    return case


def _case_scanlike_leap(rng):
    """Black border, attached bar, speckled island: a blackfilter page."""
    mask = np.zeros((2, 180, 220), bool)
    mask[:, :, :12] = True
    mask[:, 100:104, 8:180] = True
    mask[0, 140:160, 140:160] = rng.random((20, 20)) < 0.6
    seeds = np.zeros_like(mask)
    seeds[:, 50, 3] = True
    return seeds, mask, 3


def _case_coarse_level(rng):
    """Solid blocks large enough for the multigrid coarse level, joined
    by one thin diagonal link."""
    mask = np.zeros((1, 128, 160), bool)
    mask[0, 8:60, 8:70] = True
    mask[0, 70:120, 90:150] = True
    for i in range(21):
        mask[0, 59 + i // 2, 69 + i] = True
    seeds = np.zeros_like(mask)
    seeds[0, 10, 10] = True
    return seeds, mask, 1


FLOOD_CASES = {
    "random": _case_random,
    "tall_column": _case_tall_column,
    "spiral": _case_spiral,
    "wrap_row": _case_wrap_row,
    "wrap_rows_cols": _case_wrap_rows_cols,
    "no_seeds": _case_no_seeds,
    "dense_edge_seeds": _case_dense_edge_seeds,
    "leap_rows": _case_leap_rows,
    "leap2": _leap_case(2),
    "leap5": _leap_case(5),
    "scanlike_leap3": _case_scanlike_leap,
    "coarse_level": _case_coarse_level,
}


@pytest.mark.parametrize("case", sorted(FLOOD_CASES) + ["label_random",
                                                       "label_sparse"])
def test_flood_and_label_cases(rng, case):
    if case.startswith("label"):
        p = 0.4 if case == "label_random" else 0.12
        mask = rng.random((2, 80, 150)) < p
        got = np.asarray(morph.label_components(jnp.asarray(mask)))
        for b in range(2):
            want, n = scipy.ndimage.label(mask[b], structure=STRUCT8)
            assert np.all((got[b] < mask[b].size) == mask[b])
            reps = []
            for i in range(1, n + 1):
                vals = set(got[b][want == i].tolist())
                assert len(vals) == 1
                reps.append(vals.pop())
            assert len(set(reps)) == n
        return
    seeds, mask, leap = FLOOD_CASES[case](rng)
    got = np.asarray(morph.flood_reach(jnp.asarray(seeds), jnp.asarray(mask),
                                       leap=leap))
    for b in range(mask.shape[0]):
        want = (_truth_reach(seeds[b], mask[b]) if leap == 1
                else _truth_leap(seeds[b], mask[b], leap))
        np.testing.assert_array_equal(got[b], want)


# --------------------------------------------------------------------------
# noisefilter ball count, against scipy component sizes
# --------------------------------------------------------------------------

def _small_clusters(mask, k):
    lab, _ = scipy.ndimage.label(mask, structure=STRUCT8)
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    return mask & (sizes[lab] <= k)


def _noise_boundary_mask():
    """Clusters of exactly k=4 and k+1 pixels, at page edges too."""
    h, w = 140, 96
    mask = np.zeros((1, h, w), bool)
    mask[0, 0, 0:4] = True            # 4 px at the corner -> wiped
    mask[0, 10, 10:15] = True         # 5 px line -> kept
    mask[0, 30:32, 30:32] = True      # 2x2 = 4 -> wiped
    mask[0, 60:63, 60:62] = True      # 3x2 = 6 -> kept
    mask[0, h - 1, w - 4 :] = True    # 4 px bottom-right edge -> wiped
    for i in range(5):                # diagonal chain of 5 -> kept
        mask[0, 100 + i, 20 + i] = True
    return mask


@pytest.mark.parametrize("k,density", [
    (k, d) for k in (1, 2, 4, 5) for d in (0.08, 0.35, 0.6)
] + [("boundary", 4), ("narrow", 3)])
def test_noise_ball_count_cases(rng, k, density):
    if k == "boundary":
        k, mask = density, _noise_boundary_mask()
    elif k == "narrow":  # a strip narrower than the (2k+1)^2 window
        k, mask = density, rng.random((1, 5, 301)) < 0.3
    else:
        mask = rng.random((2, 97, 143)) < density
    got = np.asarray(morph.small_cluster_mask(jnp.asarray(mask), k))
    for b in range(mask.shape[0]):
        np.testing.assert_array_equal(got[b], _small_clusters(mask[b], k))


def _rounds_to_converge(seeds, mask):
    """Fewest rounds after which the plain fixed point equals the full
    reach: the count the flood's convergence test pays for, plus one."""
    full = np.asarray(morph._flood_fixed_point(
        jnp.asarray(seeds), jnp.asarray(mask), 8, mask.size + 2))
    for k in range(1, mask.size + 2):
        got = morph._flood_fixed_point(jnp.asarray(seeds), jnp.asarray(mask),
                                       8, k)
        if np.array_equal(np.asarray(got), full):
            return k, full


def test_flood_reports_rounds():
    """Rounds of the flood's fixed point: a straight run floods in one
    round; a serpentine needs one more round per turn."""
    line = np.zeros((1, 8, 64), bool)
    line[0, 3, 2:60] = True
    seeds = np.zeros_like(line)
    seeds[0, 3, 2] = True
    k, reach = _rounds_to_converge(seeds, line)
    np.testing.assert_array_equal(reach, line)
    assert k == 1

    snake = np.zeros((1, 8, 64), bool)
    snake[0, 0, :] = snake[0, 4, :] = True
    snake[0, 0:5, 63] = True
    snake[0, 4:8, 0] = True
    snake[0, 7, :] = True
    seeds = np.zeros_like(snake)
    seeds[0, 0, 0] = True
    k, reach = _rounds_to_converge(seeds, snake)
    np.testing.assert_array_equal(reach, snake)
    assert k > 1
