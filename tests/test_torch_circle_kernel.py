"""The fused circle-loss kernel (deepsir_tpu_torch/csrc/circle_loss.cu,
wrapped by ops/cuda_circle.py) on the CPU, where it cannot run: its
algorithm replayed in PyTorch in the kernel's order, held against autograd
of `circle_loss_tiled`'s plain path; the plain wrapper against the loop it
replaced, bit for bit; the helpers the wrapper hands the kernel. The test
marked `card` runs the kernel itself and skips without a GPU; on the card:
`python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_circle_kernel.py`.

The replay follows the kernel: point distances by direct difference and the
radius test `x < thres_sq`; the row minimum of pass 1; column tiles of
TILE positives in splits, the row logsumexp of the positive terms online
per tile (the tile's max, the running sum rescaled, in float64), the
negative terms shifted by their bound and summed in float64, the detector's
max over positives and min with tie counts, each row block's column sums
merged over the row blocks in order; the backward's coefficient on
dist_feat from the saved statistics, split evenly among exact ties, times
d dist_feat / d sq, reduced into d anc and d pos one column tile of the
plain version at a time, by the products and sums the wrapper runs.

Tolerances: in float32 the forward rows within 1e-6 of each one's largest
magnitude (sums in other orders). The gradients are compared in float64,
replay and autograd alike, within 1e-10 of each tensor's largest magnitude:
there the algorithm is compared, not the rounding. In float32 two correct
versions lie up to 1.05e-5 of the scale apart on these inputs (measured
over this grid): each row's softmax weights carry the float32 rounding of
its logsumexp (|lse| x 6e-8, ~2e-6 at lse ~ 30), and the 1 / (2 dist_feat)
of d dist_feat / d sq magnifies it where two descriptors nearly coincide
(dist_feat ~ 0.01 at C = 3). The card test holds the kernel's float32
gradients to 1e-5 at 18000 points, where 64 channels keep the descriptors
apart."""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import math
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from deepsir_tpu_torch.losses import detdes
from deepsir_tpu_torch.ops import cuda_circle

RADIUS = 0.9
S, MP, MN = 10.0, 0.1, 1.4
CU = Path(cuda_circle.__file__).resolve().parent.parent / "csrc" / "circle_loss.cu"


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def make_inputs(seed, batch, n, c, case):
    """Anchors in a 4-unit box, positives a permuted, jittered copy.
    "duplicates": 8 positives exact copies of anchors, the last 10 anchors
    out of reach (rows with positives and rows with no in-radius pair);
    "no_positive": no duplicate, so every row's positive set is empty;
    "all_in_radius": duplicates, and a radius that holds every pair, where
    the row minimum is a real distance."""
    rng = np.random.default_rng(seed)
    anc_pc = rng.uniform(-2.0, 2.0, size=(batch, n, 3)).astype(np.float32)
    perm = rng.permutation(n)
    pos_pc = (anc_pc[:, perm] + rng.normal(scale=0.15, size=(batch, n, 3))).astype(np.float32)
    if case != "no_positive":
        for b in range(batch):
            rows = rng.choice(n, size=8, replace=False)
            pos_pc[b, rows] = anc_pc[b, rng.choice(n - 10, size=8, replace=False)]
    if case == "duplicates":
        anc_pc[:, n - 10:] += 20.0
    anc_feat = unit(rng.normal(size=(batch, n, c)))
    pos_feat = unit(anc_feat[:, perm] + rng.normal(scale=0.6, size=(batch, n, c)))
    score = rng.uniform(0.0, 1.0, size=(batch, n)).astype(np.float32)
    radius = 100.0 if case == "all_in_radius" else RADIUS
    return [torch.from_numpy(x) for x in (anc_feat, pos_feat, anc_pc, pos_pc, score)], radius


# ---------------------------------------------------------------- the replay

def _radius_sq(radius, dtype):
    """The kernel's exact radius test in float32; r^2 in float64."""
    return cuda_circle.thres_sq(radius) if dtype == torch.float32 else radius ** 2


def _entries(a, p, apc, ppc, dmin, T):
    """Every entry's (sq, df, in_radius, positive), as csrc's `entry`."""
    d = apc[:, :, None, :] - ppc[:, None, :, :]
    x = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    dot = torch.einsum("bnc,bmc->bnm", a, p)
    sq = (-2.0 * dot + torch.sum(a * a, -1)[..., None]) + torch.sum(p * p, -1)[:, None, :]
    df = torch.sqrt(torch.clamp_min(sq, 0.0) + cuda_circle.EPS)
    positive = torch.where(dmin[..., None] == 0, x == 0, torch.sqrt(x) == dmin[..., None])
    return x, sq, df, x < T, positive


def _terms(df, in_radius, positive, K):
    neg = ~(positive | in_radius)
    u = df - MP
    tp = torch.where(neg, torch.zeros_like(df), (S * u) * torch.clamp_min(u, 0.0))
    v = MN - df
    w = torch.clamp_min(v, 0.0)
    en = torch.where(neg & (w > 0), torch.exp((S * v) * w - K),
                     torch.exp(torch.tensor(-K, dtype=df.dtype)))
    return neg, tp, en


def _split_tiles(n_other, splits):
    tiles = -(-n_other // cuda_circle.TILE)
    per = -(-tiles // splits)
    return [range(s * per, min((s + 1) * per, tiles)) for s in range(-(-tiles // per))]


def replay_forward(a, p, apc, ppc, radius, splits):
    """The kernel's forward: (lse_p, lse_n, furthest, its ties, closest, its
    ties, has_pos, lse_neg_col, dist_min)."""
    T = _radius_sq(radius, a.dtype)
    K = cuda_circle.negative_shift(S, MN)
    x0 = apc[:, :, None, :] - ppc[:, None, :, :]
    x0 = (x0[..., 0] * x0[..., 0] + x0[..., 1] * x0[..., 1]) + x0[..., 2] * x0[..., 2]
    dmin = torch.where(torch.any(x0 >= T, -1), torch.zeros(()), torch.sqrt(torch.amin(x0, -1)))
    has = torch.any(x0 < T, -1)
    x, sq, df, in_radius, positive = _entries(a, p, apc, ppc, dmin, T)
    neg, tp, en = _terms(df, in_radius, positive, K)
    cval = torch.where(positive, df + cuda_circle.BIG, df)
    b, n1, n2 = df.shape
    tl = cuda_circle.TILE
    parts = []
    for share in _split_tiles(n2, splits):
        M = df.new_zeros((b, n1))
        Sp = torch.zeros((b, n1), dtype=torch.float64)
        Sn = torch.zeros((b, n1), dtype=torch.float64)
        F, Fn = df.new_zeros((b, n1)), df.new_zeros((b, n1))
        C, Cn = df.new_full((b, n1), float("inf")), df.new_zeros((b, n1))
        for t in share:
            cols = slice(t * tl, min((t + 1) * tl, n2))
            tpt, pm, dft, cv = tp[..., cols], positive[..., cols], df[..., cols], cval[..., cols]
            m = torch.maximum(M, torch.amax(tpt, -1))
            Sp = Sp * torch.exp(M - m).double()
            M = m
            Sp = Sp + torch.where(tpt == 0, torch.exp(-M)[..., None],
                                  torch.exp(tpt - M[..., None])).sum(-1).double()
            Sn = Sn + en[..., cols].sum(-1).double()
            fmax = torch.amax(torch.where(pm, dft, torch.zeros(())), -1)
            fcnt = torch.sum(pm & (dft == fmax[..., None]) & (fmax[..., None] > 0), -1).float()
            fcnt = fcnt.to(df.dtype)
            Fn = torch.where(fmax > F, fcnt, torch.where(fmax == F, Fn + fcnt, Fn))
            F = torch.maximum(F, fmax)
            cmin = torch.amin(cv, -1)
            ccnt = torch.sum(cv == cmin[..., None], -1).to(df.dtype)
            Cn = torch.where(cmin < C, ccnt, torch.where(cmin == C, Cn + ccnt, Cn))
            C = torch.minimum(C, cmin)
        parts.append((M, Sp, Sn, F, Fn, C, Cn))
    M = torch.stack([q[0] for q in parts]).amax(0)
    Sp = sum(q[1] * torch.exp(q[0].double() - M.double()) for q in parts)
    Sn = sum(q[2] for q in parts)
    F, Fn, C, Cn = parts[0][3:]
    for q in parts[1:]:
        Fn = torch.where(q[3] > F, q[4], torch.where(q[3] == F, Fn + q[4], Fn))
        F = torch.maximum(F, q[3])
        Cn = torch.where(q[5] < C, q[6], torch.where(q[5] == C, Cn + q[6], Cn))
        C = torch.minimum(C, q[5])
    col = torch.zeros((b, n2), dtype=torch.float64)
    for r in range(0, n1, tl):                 # each row block's column sums, in order
        col = col + en[:, r:r + tl].sum(1).double()
    return dict(lse_p=(M.double() + torch.log(Sp)).to(a.dtype),
                lse_n=(K + torch.log(Sn)).to(a.dtype), furthest=F, furthest_n=Fn, closest=C,
                closest_n=Cn, has_pos=has, lse_neg_col=(K + torch.log(col)).to(a.dtype),
                dist_min=dmin)


def replay_backward(a, p, apc, ppc, radius, fwd, grads, width):
    """The kernel's backward from the forward's statistics and the gradients
    of (lse_p, lse_n, furthest, closest, lse_neg_col): d loss / d sq of every
    entry, its products with the other side's descriptors taken tile by
    tile of `width` positives as the wrapper takes them. Returns (d anc,
    d pos)."""
    T = _radius_sq(radius, a.dtype)
    K = cuda_circle.negative_shift(S, MN)
    g_p, g_n, g_f, g_c, g_col = grads
    x, sq, df, in_radius, positive = _entries(a, p, apc, ppc, fwd["dist_min"], T)
    neg, tp, _ = _terms(df, in_radius, positive, K)
    cp = S * g_p
    cn = S * g_n * torch.exp(K - fwd["lse_n"])
    ccol = S * g_col * torch.exp(K - fwd["lse_neg_col"])
    cf = g_f / torch.clamp_min(fwd["furthest_n"], 1.0)
    ccl = g_c / torch.clamp_min(fwd["closest_n"], 1.0)
    wp = torch.clamp_min(df - MP, 0.0)
    v = MN - df
    wn = torch.clamp_min(v, 0.0)
    g = torch.where(~neg & (wp > 0), cp[..., None] * torch.exp(tp - fwd["lse_p"][..., None]) * wp,
                    torch.zeros(()))
    g = g + torch.where(neg & (wn > 0), -(torch.exp((S * v) * wn - K) * wn)
                        * (cn[..., None] + ccol[:, None, :]), torch.zeros(()))
    g = g + torch.where(positive & (df == fwd["furthest"][..., None]), cf[..., None],
                        torch.zeros(()))
    cval = torch.where(positive, df + cuda_circle.BIG, df)
    g = g + torch.where(cval == fwd["closest"][..., None], ccl[..., None], torch.zeros(()))
    gp = torch.where((g != 0) & (sq >= 0), g / (2.0 * df), torch.zeros(()))

    ge = -2.0 * gp
    rows, cols = [], []
    for c0 in range(0, p.shape[1], width):         # the plain version's column tiles
        rows.append(torch.bmm(ge[..., c0:c0 + width], p[:, c0:c0 + width]))
        cols.append(torch.bmm(a.transpose(1, 2), ge[..., c0:c0 + width]).transpose(1, 2))
    d_anc = torch.stack(rows).sum(0) - a * ge.sum(-1, keepdim=True)
    return d_anc, torch.cat(cols, dim=1) - p * ge.sum(-2)[..., None]


# ---------------------------------------------------------------- the tests

def _plain(inputs, radius, overlap, tile):
    """circle_loss_tiled's plain path: (loss_feat + loss_det, its rows, d anc, d pos)."""
    anc_feat, pos_feat, anc_pc, pos_pc, score = inputs
    a = anc_feat.clone().requires_grad_(True)
    p = pos_feat.clone().requires_grad_(True)
    rows = {}

    def keep(*args, **kw):
        out = cuda_circle.circle_rows_plain(*args, **kw)
        rows.update(zip(("lse_p", "lse_n", "furthest", "closest", "has_pos", "lse_neg_col"),
                        (t.detach() for t in out)))
        return out
    with mock.patch.object(detdes, "circle_rows", keep):
        lf, ld, _ = detdes.circle_loss_tiled(a, p, anc_pc, pos_pc, score, radius,
                                             overlap_det_mask=overlap, tile=tile)
    (lf + ld).backward()
    return float((lf + ld).detach()), rows, a.grad, p.grad


def _tail_grads(fwd, inputs, radius, overlap):
    """The loss from the replay's rows through circle_loss_tiled's own tail,
    and the gradients of its rows."""
    anc_feat, pos_feat, anc_pc, pos_pc, score = inputs
    names = ("lse_p", "lse_n", "furthest", "closest", "lse_neg_col")
    leaves = {k: fwd[k].clone().requires_grad_(True) for k in names}

    def rows(*args, **kw):
        return (leaves["lse_p"], leaves["lse_n"], leaves["furthest"], leaves["closest"],
                fwd["has_pos"], leaves["lse_neg_col"])
    with mock.patch.object(detdes, "circle_rows", rows):
        lf, ld, _ = detdes.circle_loss_tiled(anc_feat, pos_feat, anc_pc, pos_pc, score, radius,
                                             overlap_det_mask=overlap)
    (lf + ld).backward()
    return float((lf + ld).detach()), [leaves[k].grad for k in names]


def _scaled(got, want):
    """Largest difference over the largest magnitude of `want` (the
    difference itself where `want` is all zero)."""
    diff = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return diff / scale if scale > 0 else diff


@pytest.mark.parametrize("case", ["duplicates", "no_positive", "all_in_radius"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("c", [3, 64])
@pytest.mark.parametrize("n", [96, 130])
@pytest.mark.parametrize("batch", [1, 2])
def test_replay_matches_autograd(batch, n, c, overlap, case):
    inputs, radius = make_inputs(7 + batch + n + c, batch, n, c, case)
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-10)):
        typed = [x.to(dtype) for x in inputs]
        anc_feat, pos_feat, anc_pc, pos_pc, _ = typed
        loss, rows, want_a, want_p = _plain(typed, radius, overlap, tile=48)
        fwd = replay_forward(anc_feat, pos_feat, anc_pc, pos_pc, radius, splits=2)
        for k, want in rows.items():
            if k == "has_pos":
                assert torch.equal(fwd[k], want)
            else:
                assert _scaled(fwd[k], want) <= tol, (dtype, k)
        if dtype == torch.float32:
            continue
        if case == "no_positive":
            assert not fwd["furthest"].any() and not fwd["furthest_n"].any()
        else:
            assert fwd["furthest_n"].sum() > 0            # some rows have positives
        if case == "all_in_radius":
            assert (fwd["dist_min"] > 0).any() and fwd["has_pos"].all()
        replay_loss, grads = _tail_grads(fwd, typed, radius, overlap)
        assert replay_loss == pytest.approx(loss, rel=tol)
        got_a, got_p = replay_backward(anc_feat, pos_feat, anc_pc, pos_pc, radius, fwd, grads,
                                       width=cuda_circle.largest_divisor(n, 48))
        assert _scaled(got_a, want_a) <= tol
        assert _scaled(got_p, want_p) <= tol


def _loop_before(anc_feat, pos_feat, anc_pc, pos_pc, anc_score, thres_radius, overlap, tile):
    """circle_loss_tiled as it was before the kernel, whole."""
    t = cuda_circle.largest_divisor(pos_feat.shape[-2], tile)
    score = anc_score / (torch.sum(anc_score, dim=-1, keepdim=True) + 1e-12)
    tiles = list(zip(torch.split(pos_feat, t, dim=-2), torch.split(pos_pc, t, dim=-2)))
    with torch.no_grad():
        dist_min = torch.full(anc_feat.shape[:-1], float("inf"))
        for _, pc in tiles:
            dist_pc = cuda_circle.dist_pc(anc_pc, pc)
            dist_min = torch.minimum(dist_min, torch.amin(dist_pc * (dist_pc < thres_radius), -1))
    shape = anc_feat.shape[:-1]
    lse_p, lse_n = torch.full(shape, -float("inf")), torch.full(shape, -float("inf"))
    furthest, closest = torch.full(shape, -float("inf")), torch.full(shape, float("inf"))
    has_pos = torch.zeros(shape, dtype=torch.bool)
    cols = []
    for pf, pc in tiles:
        dist_pc = cuda_circle.dist_pc(anc_pc, pc)
        dist_feat = cuda_circle.dist_feat(anc_feat, pf)
        false_neg = dist_pc < thres_radius
        pos_mask = dist_pc == dist_min[..., None]
        neg_mask = ~(pos_mask | false_neg)
        pos = dist_feat - 1e5 * neg_mask
        pos_w = torch.clamp_min(pos - MP, 0.0).detach()
        lse_p = torch.logaddexp(lse_p, torch.logsumexp(S * (pos - MP) * pos_w, dim=-1))
        neg = dist_feat + 1e5 * (~neg_mask)
        neg_w = torch.clamp_min(MN - neg, 0.0).detach()
        neg_weighted = S * (MN - neg) * neg_w
        lse_n = torch.logaddexp(lse_n, torch.logsumexp(neg_weighted, dim=-1))
        cols.append(torch.logsumexp(neg_weighted, dim=-2))
        furthest = torch.maximum(furthest, torch.amax(dist_feat * pos_mask, dim=-1))
        closest = torch.minimum(closest, torch.amin(dist_feat + 1e5 * pos_mask, dim=-1))
        has_pos = has_pos | torch.any(false_neg, dim=-1)
    lse_neg_col = torch.cat(cols, dim=-1)
    loss_col = detdes.softplus(lse_p + lse_n) / S
    loss_row = detdes.softplus(lse_p + lse_neg_col) / S
    loss_feat = torch.mean(loss_col + loss_row, dim=-1)
    acc, loss_det = detdes._detector(furthest - closest, has_pos, score, overlap, dim=-1)
    return loss_feat.mean(), loss_det.mean(), acc.mean()


@pytest.mark.parametrize("tile,overlap", [(48, False), (48, True), (1500, False), (7, True)])
def test_plain_wrapper_bit_equal_to_the_loop_it_replaced(tile, overlap):
    inputs, radius = make_inputs(3, 2, 96, 16, "duplicates")
    results = []
    for fn in (detdes.circle_loss_tiled, None):
        a = inputs[0].clone().requires_grad_(True)
        p = inputs[1].clone().requires_grad_(True)
        args = (a, p, inputs[2], inputs[3], inputs[4], radius)
        if fn is None:
            out = _loop_before(*args, overlap, tile)
        else:
            out = fn(*args, overlap_det_mask=overlap, tile=tile)
        (out[0] + out[1]).backward()
        results.append([*out, a.grad, p.grad])
    for got, want in zip(*results):
        assert torch.equal(got, want)


def test_thres_sq_is_the_exact_radius_test():
    for r in (0.9, 0.3, 1.0, 2.5, 1e-3, 100.0):
        t = np.float32(cuda_circle.thres_sq(r))
        below = np.nextafter(t, np.float32(0))
        assert np.sqrt(t) >= np.float32(r) and np.sqrt(below) < np.float32(r)
        xs = np.float32(r) ** 2 * np.linspace(0.999, 1.001, 2001, dtype=np.float32)
        assert np.array_equal(xs < t, np.sqrt(xs) < np.float32(r))
    assert cuda_circle.thres_sq(0.0) == 0.0


def test_splits_cover_every_tile_once():
    for own, other, sms in ((282, 282, 132), (564, 282, 132), (2, 3, 132), (1, 1, 1),
                            (282, 5, 132), (100, 282, 8)):
        n, per = cuda_circle.splits(own, other, sms)
        assert 1 <= n <= other and (n - 1) * per < other <= n * per
    assert cuda_circle.splits(282, 282, 132) == (8, 36)


def test_kernel_constants_match_the_wrapper():
    src = CU.read_text()
    assert re.search(rf"constexpr int TILE = {cuda_circle.TILE};", src)
    assert re.search(rf"constexpr int CH = {cuda_circle.CHANNELS};", src)
    assert re.search(r"constexpr float BIG = 1e5f;", src) and cuda_circle.BIG == 1e5
    assert re.search(r"constexpr float EPS = 1e-12f;", src) and cuda_circle.EPS == 1e-12


def test_negative_shift_bounds_every_negative_term():
    df = torch.linspace(0.0, 3.0, 10001)
    v = MN - df
    terms = (S * v) * torch.clamp_min(v, 0.0)
    assert float(terms.max()) <= cuda_circle.negative_shift(S, MN) * (1 + 1e-6)
    assert cuda_circle.negative_shift(S, MN) <= cuda_circle.MAX_SHIFT


def test_cpu_tensors_never_count_a_launch():
    inputs, radius = make_inputs(5, 1, 96, 8, "duplicates")
    before = cuda_circle.circle_rows.launches
    cuda_circle.circle_rows(*inputs[:4], radius)
    assert cuda_circle.circle_rows.launches == before


# ---------------------------------------------------------------- on the card

@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("case", ["jittered", "duplicates", "all_in_radius"])
@pytest.mark.parametrize("batch", [1, 2])
def test_kernel_against_plain_on_card(card, batch, case):
    """The kernel against the plain tile loop at 18000 x 18000 x 64
    (chip_smoke.circle_against_plain) on jittered positives, on exact
    duplicates with anchors out of reach, and with every pair in radius:
    rows within 1e-6 of each one's scale, the loss within 1e-6 relative,
    gradients within 1e-5 of each leaf's, two runs bit-equal."""
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = chip_smoke.circle_against_plain(torch, card, batch, case=case)
    assert rec["bit_equal_runs"] and math.isfinite(rec["loss"])
