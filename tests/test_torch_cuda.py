"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The module imports only the port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q

K1 (``fused_step_flat``), K2 (``scaled_update_flat``) and K3
(``quantize_update_flat``) are held bitwise: kernel and plain version run the
same fp32 operations in the same order, and the kernels are built without FMA
contraction (K3's int8 q exactly). K5
(``decode_attention``), K6 (``decode_sample``), K4 (``flash_attention``) and
K7 (``ssd_intra_chunk``) sum in another order than their plain versions: K5
is held to 1e-5 of max|v| in absolute error, K4 to 2e-5 of max|v| in fp32
and 1e-2 in bf16, K6's ids to the near-tie rule (``ref.near_tie_check``),
its tie cases exactly. K7 is held element by element to
u·(4·max|cum| + 2(N + Q) + 16) of the magnitude sum (the plain version on
|x|, |B|, |C|), u = 2^-24: both sum N products for C·Bᵀ and up to Q for the
rest, within (N + Q)·u of that sum each; their exps differ by <= 2 ulps;
and cum, an fp64 sum rounded once on both sides, differs by one ulp only
where the fp64 sums straddle an fp32 rounding boundary, which moves an L
by at most 4u·max|cum| relative. K7b (``ssd_intra_chunk_bwd``, K7's VJP)
is held the same way to its plain VJP on magnitudes (``k7b_bounds``), and
bitwise to itself (a second call, strided views). K4b
(``flash_attention_bwd``, K4's VJP) is held to its plain VJP on the same
out and lse element by element within u·(2·D·smax + 4·D + 2·rep·S + 32)
of the plain VJP on magnitudes (``k4b_bounds``), and bitwise to itself;
K4's training instance gives the serving instance's out bit for bit, and
the serving instance the bits of the kernel before the training instance
was added (``K4_SERVE_SHA256``).
"""
import hashlib
import math

import pytest
import torch

from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize_update as qu
from repro_torch.kernels import scaled_update as su
from repro_torch.kernels import ssd_scan as ssd

# (kind, schedule, clip, d, update_d, wd, h, s)
CASES = [
    ("identity", "const", "max", None, False, 0.0, False, False),
    ("identity", "const", "max", None, False, 0.01, False, True),
    ("adam", "debias", "max", "global", False, 0.0, False, False),
    ("adam", "debias", "add", "local", True, 0.01, False, True),
    ("adam", "const", "max", "local", True, 0.0, True, False),
    ("rmsprop", "const", "max", "local", True, 0.0, False, True),
    ("rmsprop", "debias", "add", "global", False, 0.01, False, False),
    ("adagrad", "const", "max", "local", True, 0.01, True, True),
    ("adagrad", "const", "add", "global", False, 0.0, False, True),
    ("oasis", "debias", "add", "local", True, 0.01, True, True),
]
IDS = ["-".join(str(v) for v in c) for c in CASES]
ORDER = ("p", "m", "g", "d", "h", "t", "s")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(case, M, n, dev, seed=0):
    kind, schedule, clip, dmode, update_d, wd, has_h, has_s = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = {"p": f(M, n), "m": f(M, n), "g": f(M, n), "d": None, "h": None,
         "t": torch.randint(0, 50, (M,), generator=gen, device=dev,
                            dtype=torch.int32), "s": None}
    if dmode == "local":
        x["d"] = f(M, n) if kind == "oasis" else f(M, n).abs_()
    elif dmode == "global":
        x["d"] = f(n).abs_()
    if has_h:
        x["h"] = f(M, n) if kind == "oasis" else f(M, n).square_()
    if has_s:
        x["s"] = torch.rand((M,), generator=gen, device=dev) * 0.9 + 0.1
    kw = dict(gamma=0.05, beta1=0.9, weight_decay=wd, alpha=1e-2,
              beta2=0.99, kind=kind, clip=clip, schedule=schedule,
              update_d=update_d)
    return x, kw


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4097, 4095, 4096 * 3 + 4])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k1_bitwise_vs_plain(dev, case, n):
    """Ragged n: 4·1024 and 3·4096 + 4 (float4 path), ±1 (scalar path with
    a masked tail)."""
    x, kw = _inputs(case, 3, n, dev)
    want = ref.fused_step_ref(*(x[k] for k in ORDER), **kw)
    before = su.fused_step_flat.launches
    got = ops.fused_local_step(*(x[k] for k in ORDER), **kw)
    torch.cuda.synchronize()
    assert su.fused_step_flat.launches == before + 1
    assert got[0] is x["p"] and got[1] is x["m"]        # written in place
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.cuda
def test_k1_scalar_path_on_misaligned_views(dev):
    """Rows of a buffer viewed at an odd offset are not 16-byte aligned: the
    wrapper must take the scalar path and still match bitwise."""
    x, kw = _inputs(CASES[3], 2, 4096, dev)
    for k in ("p", "m", "g", "d"):
        buf = torch.empty(x[k].numel() + 1, device=dev)
        buf[1:] = x[k].reshape(-1)
        x[k] = buf[1:].view(x[k].shape)
    want = ref.fused_step_ref(*(x[k] for k in ORDER), **kw)
    got = su.fused_step_flat(*(x[k] for k in ORDER), **kw)
    for w, g in zip(want, got):
        if w is not None:
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_k1_rejects_cpu_and_mixed_devices(dev):
    x, kw = _inputs(CASES[2], 2, 64, dev)
    x["g"] = x["g"].cpu()
    with pytest.raises(ValueError, match="g is on"):
        su.fused_step_flat(*(x[k] for k in ORDER), **kw)


def _qdq_inputs(M, n, dev, zero_rows=(), seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, n), generator=gen, device=dev) \
        * torch.rand((M, 1), generator=gen, device=dev) * 10
    x[list(zero_rows)] = 0.0
    u = torch.rand((M, n), generator=gen, device=dev)
    return x, u, x.abs().amax(dim=1) / 127.0


@pytest.mark.cuda
@pytest.mark.parametrize("M,n,zero_rows", [
    (1, 4096, ()), (4, 4097, (1,)), (4, 4095, (0, 3)), (3, 4096 * 3 + 4, (2,)),
])
def test_k3_bitwise_vs_plain(dev, M, n, zero_rows):
    """Ragged n (float4 path and scalar path with a masked tail), rows with a
    zero scale: q equal, dec bitwise."""
    x, u, s = _qdq_inputs(M, n, dev, zero_rows)
    wq, wdec = ref.quantize_update_ref(x, u, s)
    before = qu.quantize_update_flat.launches
    q, dec = ops.quantize_update(x, u, s)
    torch.cuda.synchronize()
    assert qu.quantize_update_flat.launches == before + 1
    assert torch.equal(q, wq)
    assert torch.equal(dec.view(torch.int32), wdec.view(torch.int32))


@pytest.mark.cuda
def test_k3_scalar_path_on_misaligned_views(dev):
    x, u, s = _qdq_inputs(2, 4096, dev)
    views = []
    for t in (x, u):
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:] = t.reshape(-1)
        views.append(buf[1:].view(t.shape))
    wq, wdec = ref.quantize_update_ref(*views, s)
    q, dec = qu.quantize_update_flat(*views, s)
    assert torch.equal(q, wq)
    assert torch.equal(dec.view(torch.int32), wdec.view(torch.int32))


@pytest.mark.cuda
def test_k3_rejects_mixed_devices(dev):
    x, u, s = _qdq_inputs(2, 64, dev)
    with pytest.raises(ValueError, match="u is on"):
        qu.quantize_update_flat(x, u.cpu(), s)


def _k5_inputs(B, C, Hk, rep, D, dev, one_valid=False, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Hk * rep, D), generator=gen, device=dev)
    k = torch.randn((B, C, Hk, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, C, Hk, D), generator=gen, device=dev).bfloat16()
    pos = torch.randint(0, C, (B,), generator=gen, device=dev)
    idx = torch.arange(C, device=dev)
    ok = idx[None] == pos[:, None] if one_valid else idx[None] <= pos[:, None]
    bias = torch.where(ok, 0.0, -1e30).float().contiguous()
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("one_valid", [False, True])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("B,C,rep", [(8, 576, 7), (3, 1, 7), (2, 31, 2),
                                     (1, 300, 16), (2, 4099, 7), (8, 127, 7),
                                     (8, 128, 7), (8, 129, 7), (2, 8224, 7),
                                     (1, 32768, 7)])
def test_k5_vs_plain(dev, B, C, rep, cap, one_valid):
    """C across splits and 32-position tiles with a ragged tail; one_valid
    masks all but one position per row. One call is two launches."""
    q, k, v, bias = _k5_inputs(B, C, 2, rep, 64, dev, one_valid)
    want = ref.decode_attention_ref(q, k, v, bias, softcap=cap)
    before = ds.decode_attention.launches
    got = ops.decode_attention(q, k, v, bias, softcap=cap)
    torch.cuda.synchronize()
    assert ds.decode_attention.launches == before + 2
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(v.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hk,C", [(8, 2, 576), (2, 2, 8224), (1, 1, 4099),
                                    (8, 2, 64 * 3 + 1), (8, 2, 64 * 3 - 1)])
def test_k5_one_valid_position_in_each_split(dev, B, Hk, C):
    """Every other split wholly masked: the split holding the one valid
    position decides the output, within 1e-5·max|v| (B·Hk = 1 too, and C
    one past and one short of whole splits)."""
    q, k, v, _ = _k5_inputs(B, C, Hk, 7, 64, dev)
    split, splits = ds.attention_plan(B, Hk, C)
    bound = 1e-5 * float(v.float().abs().max())
    for s in range(splits):
        for p in {s * split, min(C - 1, s * split + split // 2),
                  min(C - 1, (s + 1) * split - 1)}:
            bias = torch.full((B, C), -1e30, device=dev)
            bias[:, p] = 0.0
            got = ds.decode_attention(q, k, v, bias)
            want = ref.decode_attention_ref(q, k, v, bias)
            assert float((got - want).abs().max()) <= bound, (s, p)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [32, 64, 96, 128, 4096])
@pytest.mark.parametrize("B,C", [(8, 576), (2, 8224)])
def test_k5_any_split_length_agrees(dev, monkeypatch, B, C, split):
    """The split length (the plan's neighbours that chip_smoke.py times,
    and one split holding all of C) changes the order of the sums only:
    within 1e-5·max|v| of the plain version, two launches a call."""
    monkeypatch.setattr(ds, "attention_plan",
                        lambda B_, Hk_, C_: (split, -(-C_ // split)))
    q, k, v, bias = _k5_inputs(B, C, 2, 7, 64, dev)
    want = ref.decode_attention_ref(q, k, v, bias, softcap=30.0)
    before = ds.decode_attention.launches
    got = ds.decode_attention(q, k, v, bias, softcap=30.0)
    torch.cuda.synchronize()
    assert ds.decode_attention.launches == before + 2
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(v.float().abs().max()), err


@pytest.mark.cuda
def test_k5_is_deterministic(dev):
    """The merge adds the splits in a fixed order: two calls agree
    bitwise."""
    q, k, v, bias = _k5_inputs(2, 8224, 2, 7, 64, dev)
    assert torch.equal(ds.decode_attention(q, k, v, bias),
                       ds.decode_attention(q, k, v, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [200, 8224])
def test_k5_scalar_loads_on_odd_head_dim(dev, C):
    """D = 36 (not a multiple of 8): the kernel takes its scalar loads."""
    q, k, v, bias = _k5_inputs(2, C, 2, 7, 36, dev)
    want = ref.decode_attention_ref(q, k, v, bias)
    got = ds.decode_attention(q, k, v, bias)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        v.float().abs().max())


# K5 at D = 256 (gemma3: B 2, C 4160, Hk 4, rep 2), whose lanes take a
# whole warp and whose ring has 3 stages: the path's shape, C of one tile
# and across tiles, rep 4, a D of 160 that pads the row to 256 and one of
# 200 (not a multiple of 8: scalar loads); ``window`` masks all but the
# last 1024 positions (gemma3's local layers), 0 leaves the causal bias
@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("B,C,Hk,rep,D", [(2, 4160, 4, 2, 256),
                                          (1, 33, 4, 2, 256),
                                          (3, 129, 2, 4, 256),
                                          (2, 4160, 4, 2, 160),
                                          (2, 300, 1, 1, 200)])
def test_k5_head_dim_256_vs_plain(dev, B, C, Hk, rep, D, window):
    q, k, v, bias = _k5_inputs(B, C, Hk, rep, D, dev)
    if window:
        idx = torch.arange(C, device=dev)
        last = torch.where(bias == 0, idx, -1).max(dim=1).values
        bias[(last[:, None] - idx[None]) >= window] = -1e30
    for cap in (0.0, 30.0):
        want = ref.decode_attention_ref(q, k, v, bias, softcap=cap)
        got = ops.decode_attention(q, k, v, bias, softcap=cap)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(v.float().abs().max()), (cap, err)


@pytest.mark.cuda
def test_k5_rejects_mixed_devices_and_types(dev):
    q, k, v, bias = _k5_inputs(2, 16, 2, 7, 64, dev)
    with pytest.raises(ValueError, match="bias is on"):
        ds.decode_attention(q, k, v, bias.cpu())
    with pytest.raises(ValueError, match="k must be"):
        ds.decode_attention(q, k.float(), v, bias)


def _k6_inputs(B, V, d, dev, greedy, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((B, d), generator=gen, device=dev)
    table = torch.randn((V, d), generator=gen, device=dev) * 0.02
    noise = torch.zeros((B, V), device=dev) if greedy else \
        -torch.log(-torch.log(torch.rand((B, V), generator=gen, device=dev)
                              .clamp_min(torch.finfo(torch.float32).tiny)))
    return y, table, noise


@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("B,V,v_real,d", [(1, 153600, 151936, 896),
                                          (8, 153600, 151936, 896),
                                          (32, 153600, 151936, 896),
                                          (3, 8192, 8000, 112),
                                          (64, 4096, 4096, 128)])
def test_k6_vs_plain(dev, B, V, v_real, d, greedy):
    y, table, noise = _k6_inputs(B, V, d, dev, greedy)
    scale = d ** -0.5
    logits = ref.decode_sample_logits(y, table, noise, scale=scale,
                                      v_real=v_real)
    want = ref.decode_sample_ref(y, table, noise, scale=scale, v_real=v_real)
    before = ds.decode_sample.launches
    got = ops.decode_sample(y, table, noise, scale=scale, v_real=v_real)
    torch.cuda.synchronize()
    assert ds.decode_sample.launches == before + 1
    ties, bad = ref.near_tie_check(logits, got, want, v_real)
    assert bad == 0 and ties <= max(1, B // 8), (ties, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(100, 101), (100, 90000), (7, 151935)])
def test_k6_duplicated_rows_lower_index_wins(dev, rows):
    """Identical rows give identical logits wherever they fall in the grid,
    and the lower index wins."""
    y, table, noise = _k6_inputs(4, 153600, 896, dev, greedy=True)
    lo, hi = rows
    table[lo] = table[hi] = y[0] / y[0].norm() * 5.0
    ids, best = ds.decode_sample(y, table, noise, scale=896 ** -0.5,
                                 v_real=151936, return_best=True)
    assert int(ids[0]) == lo


@pytest.mark.cuda
def test_k6_masked_padded_id_never_wins(dev):
    y, table, noise = _k6_inputs(4, 153600, 896, dev, greedy=True)
    table[151936 + 9] = y[1] / y[1].norm() * 50.0
    got = ds.decode_sample(y, table, noise, scale=896 ** -0.5, v_real=151936)
    logits = ref.decode_sample_logits(y, table, noise, scale=896 ** -0.5,
                                      v_real=151936)
    assert int(got.max()) < 151936
    assert ref.near_tie_check(logits, got, logits.argmax(dim=1),
                              151936)[1] == 0


@pytest.mark.cuda
def test_k6_rejects_bad_arguments(dev):
    y, table, noise = _k6_inputs(2, 4096, 128, dev, greedy=True)
    with pytest.raises(ValueError, match="noise is on"):
        ds.decode_sample(y, table, noise.cpu(), scale=1.0, v_real=4096)
    with pytest.raises(ValueError, match="16-byte aligned"):
        buf = torch.empty(table.numel() + 1, device=dev)
        ds.decode_sample(y, buf[1:].view(4096, 128), noise, scale=1.0,
                         v_real=4096)


def _k4_inputs(B, S, H, Hk, D, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D))]


def _k4_bound(v):
    """K4's tolerance against its plain version: 2e-5·max|v| in fp32,
    1e-2·max|v| in bf16 (both round the output to bf16)."""
    tol = 2e-5 if v.dtype == torch.float32 else 1e-2
    return tol * float(v.float().abs().max())


# (B, S, H, Hk, D, window, softcap, dtype): the prefill's heads at a reduced
# S, MQA, D of 32/64/128 and 30 (scalar loads), windows cutting tiles on
# both sides, softcap, bf16, S = 1 and S not a multiple of the 64-row tile
# (one past, one short, with windows, bf16 and D = 128)
K4_CASES = [(2, 1024, 14, 2, 64, 0, 0.0, torch.float32),
            (2, 512, 8, 1, 64, 0, 0.0, torch.float32),
            (1, 256, 4, 2, 32, 0, 0.0, torch.float32),
            (1, 256, 4, 2, 128, 0, 0.0, torch.float32),
            (1, 200, 4, 2, 30, 0, 0.0, torch.float32),
            (2, 256, 4, 2, 64, 16, 0.0, torch.float32),
            (2, 300, 4, 2, 64, 100, 0.0, torch.float32),
            (2, 256, 4, 2, 64, 0, 30.0, torch.float32),
            (2, 512, 14, 2, 64, 0, 0.0, torch.bfloat16),
            (2, 1, 14, 2, 64, 0, 0.0, torch.float32),
            (2, 1000, 14, 2, 64, 0, 0.0, torch.float32),
            (1, 65, 4, 2, 64, 0, 0.0, torch.float32),
            (1, 127, 4, 2, 128, 0, 0.0, torch.float32),
            (1, 191, 4, 2, 32, 40, 0.0, torch.float32),
            (1, 97, 4, 2, 64, 0, 0.0, torch.bfloat16),
            (1, 1111, 4, 2, 128, 70, 30.0, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hk,D,window,cap,dtype", K4_CASES)
def test_k4_vs_plain(dev, B, S, H, Hk, D, window, cap, dtype):
    q, k, v = _k4_inputs(B, S, H, Hk, D, dtype, dev)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _k4_bound(v), err


# K4 at D = 256 (the 256-thread, 32-key-tile instance; gemma3's B 2, H 8,
# Hk 4): full causal and with windows (its local layers' 1024 at S 4096),
# S not a multiple of the 64-row tile with softcap, S = 1, bf16, a D of 160
# that pads to 256 and one of 250 (not a multiple of 4: scalar loads)
K4_WIDE_CASES = [(2, 512, 8, 4, 256, 0, 0.0, torch.float32),
                 (2, 512, 8, 4, 256, 64, 0.0, torch.float32),
                 (1, 4096, 8, 4, 256, 1024, 0.0, torch.float32),
                 (1, 1025, 8, 4, 256, 300, 30.0, torch.float32),
                 (2, 1, 8, 4, 256, 0, 0.0, torch.float32),
                 (1, 97, 8, 4, 256, 0, 0.0, torch.bfloat16),
                 (1, 333, 8, 4, 160, 0, 0.0, torch.float32),
                 (1, 200, 4, 2, 250, 40, 0.0, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hk,D,window,cap,dtype", K4_WIDE_CASES)
def test_k4_head_dim_256_vs_plain(dev, B, S, H, Hk, D, window, cap, dtype):
    q, k, v = _k4_inputs(B, S, H, Hk, D, dtype, dev)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _k4_bound(v), err


@pytest.mark.cuda
def test_k4_reads_strided_views(dev):
    """q, k, v as views of other layouts (heads before sequence, a slice of
    a wider last dim, a d stride of 2) give what contiguous copies give."""
    B, S, H, Hk, D = 2, 320, 6, 2, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, H, S, D), generator=gen, device=dev).transpose(1, 2)
    k = torch.randn((B, S, Hk, 2 * D), generator=gen, device=dev)[..., :D]
    v = torch.randn((B, S, Hk, 2 * D), generator=gen, device=dev)[..., ::2]
    want = ref.flash_attention_ref(q, k, v)
    got = fa.flash_attention(q, k, v)
    assert float((got - want).abs().max()) <= _k4_bound(v)
    same = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert float((got - same).abs().max()) <= _k4_bound(v)


@pytest.mark.cuda
def test_k4_rejects_grad_and_mixed_devices(dev):
    q, k, v = _k4_inputs(1, 64, 2, 2, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="forward-only"):
        ops.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="one device"):
        ops.flash_attention(q.detach(), k.cpu(), v)


# --------------------------------------------------------------------------- #
# K4's training instance and K4b, its VJP
# --------------------------------------------------------------------------- #


def _int_inputs(shape, salt, dev):
    """Exact fp32 values in [-4, 4) from integer arithmetic alone, so that
    every machine and PyTorch version makes the same bits."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=dev)
    x = (i * 2654435761 + salt * 40503) % 65521 - 32760
    return (x.to(torch.float32) / 8192.0).reshape(shape)


# (B, S, H, Hk, D, window, softcap, dtype) and the sha256 of the serving
# instance's out bytes, recorded from the kernel before the training
# instance was added (H100, nvcc 12.8); the inputs are ``_int_inputs``
K4_SERVE_SHA256 = {
    (2, 1024, 14, 2, 64, 0, 0.0, torch.float32):
        "1dedc0c59939d2371741ad1dcb2e2e2af460d6b5e2b6200b7e7dbbd4ee98cf08",
    (2, 300, 4, 2, 64, 100, 30.0, torch.float32):
        "067c6eeb99c81860e03e2e7fdf86e82fc2a66ca9bcf09f14e98b162d868232a6",
    (1, 512, 8, 4, 256, 64, 0.0, torch.float32):
        "d765c2a6819710ced9b93c8c253e741217f904303b2816300bf4ec2c0b66d9a6",
    (1, 256, 14, 2, 64, 0, 0.0, torch.bfloat16):
        "fd58f6e39fd41da293f20cd6bfe486219cc472a2300c33f6350a2103aea78ede",
}


def k4_serve_digest(B, S, H, Hk, D, window, cap, dtype, dev):
    q, k, v = (_int_inputs(shape, salt, dev).to(dtype) for salt, shape in
               enumerate(((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D))))
    out = fa.flash_attention(q, k, v, window=window, softcap=cap)
    return hashlib.sha256(out.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32).cpu().numpy()
                          .tobytes()).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K4_SERVE_SHA256), ids=str)
def test_k4_serving_bits_unchanged(dev, case):
    """Serving's K4 gives the bits it gave before K4 had a training
    instance (a toolchain other than nvcc 12.8 may round elsewhere)."""
    assert k4_serve_digest(*case, dev) == K4_SERVE_SHA256[case]


def _k4b_inputs(B, S, H, Hk, D, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev)
            for shape in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D),
                          (B, S, H, D))]


def k4b_bounds(q, k, v, out, lse, dout, window, cap):
    """K4b's per-element bounds against its plain VJP:
    u·(2·D·smax + 4·D + 2·rep·S + 32), u = 2^-24, times the plain VJP on
    magnitudes. smax = D^-½·max‖q_r‖·max‖k_c‖ bounds Σ_d |q'_d k_d| of
    any pair, so both sides' scores, each a chain of D products, lie
    within D·u·smax of the exact ones, and p = exp(s − lse) within
    2·D·u·smax relatively (the same lse on both sides; the softcap's
    slope is at most 1); dp and delta are sums of D products; dq sums up
    to S keys, dk and dv up to rep·S rows of a kv head's query heads."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    smax = D ** -0.5 * float(q.norm(dim=-1).max() * k.norm(dim=-1).max())
    eps = 2.0 ** -24 * (2 * D * smax + 4 * D + 2 * rep * S + 32)
    mags = ref.flash_attention_vjp_ref(q, k, v, out, lse, dout,
                                       window=window, softcap=cap,
                                       magnitudes=True)
    return [eps * m for m in mags]


# (B, S, H, Hk, D, window, softcap): the qwen2 cell's heads, nemotron's 32/2
# at D 128 (rep 16), S not a multiple of 64, MQA, rep 1, a window, a
# softcap, both, D 80 and 32 (padded to 128 and 64), S = 1; splits of the
# rep heads: all (small grids), 2 of 4 (8, 2048, 8, 2) and none (rep 1)
K4B_CASES = [(2, 256, 14, 2, 64, 0, 0.0), (1, 512, 32, 2, 128, 0, 0.0),
             (1, 200, 4, 2, 128, 0, 0.0), (2, 130, 8, 1, 64, 0, 0.0),
             (2, 300, 4, 2, 64, 100, 0.0), (1, 256, 4, 2, 64, 0, 30.0),
             (1, 333, 4, 4, 80, 70, 30.0), (1, 191, 4, 2, 32, 0, 0.0),
             (2, 1, 14, 2, 64, 0, 0.0), (8, 2048, 8, 2, 64, 0, 0.0),
             (2, 2048, 4, 4, 64, 0, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hk,D,window,cap", K4B_CASES)
def test_k4b_vs_plain(dev, B, S, H, Hk, D, window, cap):
    q, k, v, dout = _k4b_inputs(B, S, H, Hk, D, dev)
    out, lse = fa.flash_attention_lse(q, k, v, window=window, softcap=cap)
    want = ref.flash_attention_vjp_ref(q, k, v, out, lse, dout,
                                       window=window, softcap=cap)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, window=window,
                                 softcap=cap)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    bounds = k4b_bounds(q, k, v, out, lse, dout, window, cap)
    for name, g, w, bd, t in zip(("dq", "dk", "dv"), got, want, bounds,
                                 (q, k, v)):
        assert g.shape == t.shape and g.dtype == torch.float32, name
        assert g.is_contiguous(), name
        assert bool(((g - w).abs() <= bd).all()), \
            (name, float(((g - w).abs() / bd.clamp_min(1e-30)).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hk,D,window,cap", [
    (2, 256, 14, 2, 64, 0, 0.0), (1, 200, 4, 2, 128, 40, 30.0),
    (2, 97, 4, 2, 64, 0, 0.0)])
def test_k4_lse_instance_matches_serving_and_plain(dev, B, S, H, Hk, D,
                                                   window, cap):
    """The training instance's out is the serving instance's bit for bit;
    its lse is the plain log-sum-exp within u·(2·D·smax + 2·S + 16 +
    |lse|) (the scores' error, l's sum of up to S terms, m + log l)."""
    q, k, v, _ = _k4b_inputs(B, S, H, Hk, D, dev)
    out, lse = fa.flash_attention_lse(q, k, v, window=window, softcap=cap)
    assert torch.equal(out, fa.flash_attention(q, k, v, window=window,
                                               softcap=cap))
    _, want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap,
                                      with_lse=True)
    smax = D ** -0.5 * float(q.norm(dim=-1).max() * k.norm(dim=-1).max())
    tol = 2.0 ** -24 * (2 * D * smax + 2 * S + 16 + float(want.abs().max()))
    assert lse.shape == (B, H, S) and float((lse - want).abs().max()) <= tol


@pytest.mark.cuda
def test_k4b_is_deterministic(dev):
    """No atomics; dq's key sums, dk and dv's row and head sums and the
    splits' sum in a fixed order: two calls give the same bits, and views
    of other layouts the bits of contiguous copies. K4's training instance
    too gives the same out and lse twice (remat's recompute rebuilds a
    layer from them)."""
    B, S, H, Hk, D = 2, 1024, 32, 2, 128
    q, k, v, dout = _k4b_inputs(B, S, H, Hk, D, dev)
    out, lse = fa.flash_attention_lse(q, k, v)
    out2, lse2 = fa.flash_attention_lse(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    second = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    for u, w in zip(first, second):
        assert torch.equal(u, w)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    kw = torch.cat([k, k], dim=-1)[..., :D]
    third = fa.flash_attention_bwd(qt, kw, v, out, lse, dout[:, :, :, :])
    for u, w in zip(first, third):
        assert torch.equal(u, w)


@pytest.mark.cuda
def test_k4_route_layer_grads_match_dense(dev, monkeypatch):
    """One full-width qwen2-0.5b attention layer at the cell's call (B 4,
    S 1024): its parameter gradients through the route (K4 + K4b) against
    the dense route's, each leaf to 1e-3 of its largest magnitude, the size
    of K4b's rounding bound at this shape (u·2·rep·S ≈ 8.5e-4 of the
    magnitudes); one route call, one K4b call, the counter once."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.utils import trace
    from repro_torch.utils.tree import tree_paths, tree_unflatten
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=dev).manual_seed(5)
    p = layers.init_attention(gen, cfg)
    for leaf in ("wq", "wk", "wv"):
        p[leaf]["b"].normal_(generator=gen)
    x = torch.randn((4, 1024, cfg.d_model), generator=gen, device=dev)
    w = torch.randn((4, 1024, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(1024, dtype=torch.int32, device=dev)
    real = layers._takes_k4

    def grads(route):
        monkeypatch.setattr(layers, "_takes_k4",
                            real if route else (lambda *t: False))
        before = fa.flash_attention_bwd.launches
        paths = [(k, t.clone().requires_grad_()) for k, t in tree_paths(p)]
        with trace.recording() as rec:
            out, _ = layers.attention(tree_unflatten(p, [t for _, t in paths]),
                                      cfg, x, pos, layers.AttnCall(),
                                      torch.float32)
            g = torch.autograd.grad((out * w).sum(), [t for _, t in paths])
            torch.cuda.synchronize()
        n = sum(c.get("model.attn_k4", 0) for c in rec.collect()[1].values())
        return ({k: gi for (k, _), gi in zip(paths, g)},
                fa.flash_attention_bwd.launches - before, n)

    got, n_bwd, n_route = grads(True)
    assert n_bwd == 1 and n_route == 1
    want, n_plain, n_dense = grads(False)
    assert n_plain == 0 and n_dense == 0
    for k in want:
        tol = 1e-3 * float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= tol, k


@pytest.mark.cuda
def test_k4_route_second_order_matches_dense(dev, monkeypatch):
    """A Hessian-vector product through one full-width qwen2-0.5b attention
    layer (B 2, S 256), reverse over reverse as
    ``preconditioner.hutchinson_diag`` takes it: through the route (K4's
    forward; the differentiated backward on the plain forward's graph)
    against the dense route's, each leaf to 1e-3 of its largest magnitude
    (the first-order test's tolerance; a dropped second-order term moves a
    leaf by its whole size). K4b runs once, in the second pass: the output
    projection's weight gradient reads K4's out, and its term is a
    first-order VJP. The counter reads one routed call, and
    ``FlopCounterMode`` counts K4's forward by its formula."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.utils import trace
    from repro_torch.utils.tree import tree_paths, tree_unflatten
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=dev).manual_seed(6)
    p = layers.init_attention(gen, cfg)
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device=dev)
    w = torch.randn((2, 256, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(256, dtype=torch.int32, device=dev)
    probe = {k: torch.randn(t.shape, generator=gen, device=dev)
             for k, t in tree_paths(p)}
    real = layers._takes_k4

    def hvp(route):
        monkeypatch.setattr(layers, "_takes_k4",
                            real if route else (lambda *t: False))
        before = fa.flash_attention_bwd.launches
        paths = [(k, t.clone().requires_grad_()) for k, t in tree_paths(p)]
        xs = [t for _, t in paths]
        with trace.recording() as rec, FlopCounterMode(display=False) as fc:
            out, _ = layers.attention(tree_unflatten(p, xs), cfg, x, pos,
                                      layers.AttnCall(), torch.float32)
            flops = fc.get_total_flops()
            g = torch.autograd.grad((out * w).sum(), xs, create_graph=True)
            hv = torch.autograd.grad(sum((gi * probe[k]).sum() for (k, _), gi
                                         in zip(paths, g)), xs)
            torch.cuda.synchronize()
        n = sum(c.get("model.attn_k4", 0) for c in rec.collect()[1].values())
        return ({k: h for (k, _), h in zip(paths, hv)},
                fa.flash_attention_bwd.launches - before, n, flops)

    got, n_bwd, n_route, flops = hvp(True)
    assert n_bwd == 1 and n_route == 1
    want, _, n_dense, flops_dense = hvp(False)
    assert n_dense == 0
    attn = fa.work(2, 256, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)[0]
    dense = 4 * 2 * cfg.n_heads * 256 * 256 * cfg.head_dim
    assert flops - attn == flops_dense - dense
    for k in want:
        tol = 1e-3 * float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= tol, k


@pytest.mark.cuda
def test_attn_k4_counts_in_a_training_round(dev):
    """One round of the qwen2-0.5b training cell's job (24 layers at full
    width; savic, Adam D at sync, fused K1; M 4, H 2, b 4, S 1024) under
    the recorder: ``model.attn_k4`` counts 384 routed calls (192 forward,
    192 remat recompute: M·H·24), K4 launches 384 times and K4b 192."""
    from repro_torch.launch import train
    from repro_torch.utils import trace
    run = train.setup(["--arch", "qwen2-0.5b", "--device", "cuda", "--seed",
                       "11", "--dtype", "float32", "--method", "savic",
                       "--preconditioner", "adam", "--scaling", "global",
                       "--clients", "4", "--h-local", "2", "--batch", "4",
                       "--seq", "1024", "--use-fused-kernel"])
    batch = train.round_batch(run.loader, run.args, 0, run.device)
    k4, k4b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    with trace.recording() as rec:
        state, met = run.round_step(run.state, batch, run.stream(0))
        torch.cuda.synchronize()
    _, counters = rec.collect()
    assert counters[0]["model.attn_k4"] == 384
    assert fa.flash_attention.launches - k4 == 384
    assert fa.flash_attention_bwd.launches - k4b == 192
    assert bool(torch.isfinite(met["loss"]).all())


# (B, S, H, P, N, Q, A, shared B/C): the serve prefill's shape with one
# B/C group over the heads (head stride 0), per-head B/C, Q 64/128 with N
# 16/64 and P 32/128, one chunk (the continuous-batching prefill), A = -16
# (max|cum| in the thousands), ragged P, N and Q, B with head stride 0 beside
# a per-head C ("B": the per-head G path), and the one chunk with A = -16
K7_CASES = [(4, 2048, 64, 64, 128, 256, None, True),
            (2, 1024, 16, 64, 128, 256, None, False),
            (2, 512, 8, 32, 16, 64, None, False),
            (2, 512, 8, 128, 64, 128, None, False),
            (2, 512, 8, 128, 16, 64, None, True),
            (2, 512, 8, 32, 64, 128, None, True),
            (1, 256, 64, 64, 128, 256, None, True),
            (2, 1024, 8, 64, 128, 256, -16.0, True),
            (1, 144, 3, 30, 20, 48, None, False),
            (2, 512, 8, 64, 64, 128, None, "B"),
            (1, 256, 64, 64, 128, 256, -16.0, True)]


def _k7_inputs(B, S, H, P, N, dev, a=None, shared=False, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = f(B, S, H, P)
    dt = torch.nn.functional.softplus(f(B, S, H))
    A = torch.full((H,), a, device=dev) if a is not None else -torch.exp(f(H))
    Bm = f(B, S, 1, N).expand(B, S, H, N) if shared else f(B, S, H, N)
    Cm = f(B, S, 1, N).expand(B, S, H, N) if shared is True \
        else f(B, S, H, N)
    return x, dt, A, Bm, Cm


def k7_bounds(x, dt, A, Bm, Cm, chunk):
    """K7's per-element bounds against its plain version (module
    docstring): u·(4·max|cum| + 2(N + Q) + 16) times the plain version on
    |x|, |B|, |C|."""
    B, S, H = dt.shape
    cmax = float((dt * A.abs()).reshape(B, S // chunk, chunk, H).sum(2).max())
    eps = 2.0 ** -24 * (4 * cmax + 2 * (Bm.shape[-1] + chunk) + 16)
    mags = ref.ssd_intra_chunk_ref(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk)
    return [eps * m for m in mags], cmax


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,Q,a,shared", K7_CASES)
def test_k7_vs_plain(dev, B, S, H, P, N, Q, a, shared):
    x, dt, A, Bm, Cm = _k7_inputs(B, S, H, P, N, dev, a, shared)
    want = ref.ssd_intra_chunk_ref(x, dt, A, Bm, Cm, Q)
    before = ssd.ssd_intra_chunk.launches
    got = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    assert ssd.ssd_intra_chunk.launches == before + 1
    bounds, cmax = k7_bounds(x, dt, A, Bm, Cm, Q)
    nc = S // Q
    for g, w, bd, shape in zip(got, want, bounds,
                               ((B, S, H, P), (B, nc, H, N, P), (B, nc, H))):
        assert g.shape == shape and g.dtype == torch.float32
        assert bool(((g - w).abs() <= bd).all()), \
            float(((g - w).abs() / bd.clamp_min(1e-30)).max())
    if a is not None:
        assert cmax > 2000.0


@pytest.mark.cuda
def test_k7_is_deterministic(dev):
    """No atomics, no sum split across blocks: two calls on the same inputs
    give the same bits in all three outputs."""
    B, S, H, P, N, Q = 4, 2048, 64, 64, 128, 256
    x, dt, A, Bm, Cm = _k7_inputs(B, S, H, P, N, dev, shared=True)
    first = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    second = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    for u, v in zip(first, second):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_k7_reads_strided_views(dev):
    """x, dt, B, C as views of other layouts (heads before sequence, every
    other element of a wider dim, one group expanded) give what contiguous
    copies give."""
    B, S, H, P, N, Q = 2, 256, 4, 64, 32, 128
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((B, H, S, P), generator=gen, device=dev).transpose(1, 2)
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, 2 * H), generator=gen, device=dev))[..., ::2]
    A = -torch.exp(torch.randn((2 * H,), generator=gen, device=dev))[::2]
    Bm = torch.randn((B, S, 1, 2 * N), generator=gen,
                     device=dev)[..., :N].expand(B, S, H, N)
    Cm = torch.randn((B, S, H, N), generator=gen, device=dev)
    got = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    same = ssd.ssd_intra_chunk(x.contiguous(), dt.contiguous(),
                               A.contiguous(), Bm.contiguous(), Cm, Q)
    bounds, _ = k7_bounds(x, dt, A, Bm, Cm, Q)
    for g, s_, bd in zip(got, same, bounds):
        assert bool(((g - s_).abs() <= bd).all())


@pytest.mark.cuda
def test_k7_route_matches_chunked_ssd(dev):
    """``ops.ssd`` (K7 + the inter-chunk recurrence, from an h0) and
    ``models.ssm.ssd_chunked`` without grad (the model's route: one K7
    call, B/C as one group) against the plain scan ``_ssd_chunked`` on the
    card."""
    from repro_torch.models import ssm
    x, dt, A, Bm, Cm = _k7_inputs(2, 1024, 8, 64, 128, dev, shared=True)
    h0 = torch.randn((2, 8, 64, 128), device=dev)
    y, h = ops.ssd(x, dt, A, Bm, Cm, chunk=256, h0=h0)
    before = ssd.ssd_intra_chunk.launches
    with torch.no_grad():
        ym, hm = ssm.ssd_chunked(x, dt, A, Bm[:, :, :1], Cm[:, :, :1], 256,
                                 h0=h0)
    assert ssd.ssd_intra_chunk.launches == before + 1
    yw, hw = ssm._ssd_chunked(x, dt, A, Bm, Cm, 256, h0)
    my, mh = ssm._ssd_chunked(x.abs(), dt, A, Bm.abs(), Cm.abs(), 256,
                              h0.abs())
    cmax = float((dt * A.abs()).reshape(2, 4, 256, 8).sum(2).max())
    eps = 2.0 ** -24 * (4 * cmax + 2 * (128 + 256) + 32)
    for yk, hk in ((y, h), (ym, hm)):
        assert bool(((yk - yw).abs() <= eps * my).all())
        assert bool(((hk - hw).abs() <= eps * mh).all())


@pytest.mark.cuda
def test_k7_rejects_grad_limits_and_mixed_devices(dev):
    x, dt, A, Bm, Cm = _k7_inputs(1, 64, 2, 16, 8, dev)
    with pytest.raises(ValueError, match="forward-only"):
        ops.ssd(x.requires_grad_(), dt, A, Bm, Cm, chunk=16)
    x = x.detach()
    with pytest.raises(ValueError, match="one device"):
        ssd.ssd_intra_chunk(x, dt.cpu(), A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="dividing S"):
        ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, 24)
    wide = torch.zeros((1, 64, 2, 129), device=dev)
    with pytest.raises(ValueError, match="N <= 128"):
        ops.ssd(x, dt, A, wide, wide, chunk=16)


@pytest.mark.cuda
def test_k7_launches_through_serve(dev):
    """``serve`` on the card prefills through K7 by default, one call a
    layer, and decodes on K6."""
    from repro_torch.launch import serve
    ssd.ssd_intra_chunk.launches = 0
    ds.decode_sample.launches = 0
    res = serve.serve("mamba2-1.3b", reduced=True, batch=2, prompt_len=64,
                      gen_len=4, use_decode_kernel=True, verbose=False,
                      device="cuda")
    assert ssd.ssd_intra_chunk.launches == 2
    assert ds.decode_sample.launches == 3
    assert res.tokens.shape == (2, 4) and int(res.tokens.max()) < 512


# K7b, the VJP of K7: (B, S, H, P, N, Q, G, A) the training call's shape
# with one B/C group, per-head B/C, P 128 (the second dx instance), ragged
# P, N and Q with one group and per head, P 32 with N 16, zamba2's 80 heads
# (ten splits of eight), one chunk, A = -16 (max|cum| in the thousands)
K7B_CASES = [(2, 2048, 64, 64, 128, 256, 1, None),
             (2, 1024, 16, 64, 128, 256, 16, None),
             (2, 512, 8, 128, 64, 128, 1, None),
             (1, 144, 3, 30, 20, 48, 1, None),
             (1, 144, 3, 30, 20, 48, 3, None),
             (2, 512, 8, 32, 16, 64, 8, None),
             (2, 1024, 80, 64, 64, 256, 1, None),
             (1, 256, 64, 64, 128, 256, 1, None),
             (2, 1024, 8, 64, 128, 256, 1, -16.0)]


def _k7b_inputs(B, S, H, P, N, Q, G, dev, a=None, seed=0):
    """K7's inputs with B/C as (B, S, G, N) groups, and K7's cotangents."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(f(B, S, H))
    A = torch.full((H,), a, device=dev) if a is not None else -torch.exp(f(H))
    ins = (f(B, S, H, P), dt, A, f(B, S, G, N), f(B, S, G, N))
    nc = S // Q
    return ins, (f(B, S, H, P), f(B, nc, H, N, P), f(B, nc, H))


def k7b_bounds(ins, Q, cots):
    """K7b's per-element bounds against its plain version:
    u·(4·max|cum| + 2(N + Q + P + H/G) + hs·P + 16), u = 2^-24, times the
    plain VJP on magnitudes (``magnitudes=True``). Both sides sum P
    products for M and the rows of x·dxdt, N for G and B·dS, up to Q for
    Wᵀ·dY, dG·B, dGᵀ·C and the row sums of R, H/G heads for dG; the kernel
    sums (xdt·decay)·dSᵀ over a split's hs = ``ssd.HEADS_A_SPLIT`` heads in
    one chain of hs·P products; the exps and cum move as K7's bound says
    (module docstring); the fp64 reverse cumsum and dA's fp64 sum add at
    most an ulp of the result."""
    x, dt, A, Bg, Cg = ins
    B, S, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    cmax = float((dt * A.abs()).reshape(B, S // Q, Q, H).sum(2).max())
    hs = ssd.HEADS_A_SPLIT if G == 1 else 1
    eps = 2.0 ** -24 * (4 * cmax + 2 * (N + Q + P + H // G) + hs * P + 16)
    mags = ref.ssd_intra_chunk_vjp_ref(*ins, Q, *cots, magnitudes=True)
    return [eps * m for m in mags], cmax


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,Q,G,a", K7B_CASES)
def test_k7b_vs_plain(dev, B, S, H, P, N, Q, G, a):
    ins, cots = _k7b_inputs(B, S, H, P, N, Q, G, dev, a)
    want = ref.ssd_intra_chunk_vjp_ref(*ins, Q, *cots)
    before = ssd.ssd_intra_chunk_bwd.launches
    got = ssd.ssd_intra_chunk_bwd(*ins, Q, *cots)
    torch.cuda.synchronize()
    assert ssd.ssd_intra_chunk_bwd.launches == before + 1
    bounds, cmax = k7b_bounds(ins, Q, cots)
    for name, g, w, bd, t in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                                 bounds, ins):
        assert g.shape == t.shape and g.dtype == torch.float32, name
        assert g.is_contiguous(), name
        assert bool(((g - w).abs() <= bd).all()), \
            (name, float(((g - w).abs() / bd.clamp_min(1e-30)).max()))
    if a is not None:
        assert cmax > 2000.0


@pytest.mark.cuda
def test_k7b_is_deterministic(dev):
    """No atomics; every cross-head, cross-tile and cross-cell sum in a
    fixed order: two calls give the same bits in all five outputs."""
    ins, cots = _k7b_inputs(2, 2048, 64, 64, 128, 256, 1, dev)
    first = ssd.ssd_intra_chunk_bwd(*ins, 256, *cots)
    second = ssd.ssd_intra_chunk_bwd(*ins, 256, *cots)
    for u, v in zip(first, second):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
def test_k7b_reads_strided_views(dev, G):
    """x, dt, A, B and C as views of other layouts (heads before sequence,
    every other element of a wider dim, a group expanded from one) give
    the bits of contiguous copies: every element is read, never summed
    differently, by its strides."""
    B, S, H, P, N, Q = 2, 256, 4, 64, 32, 128
    gen = torch.Generator(device=dev).manual_seed(3)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = r(B, H, S, P).transpose(1, 2)
    dt = torch.nn.functional.softplus(r(B, S, 2 * H))[..., ::2]
    A = -torch.exp(r(2 * H))[::2]
    Bg = r(B, G, S, 2 * N).transpose(1, 2)[..., ::2]
    Cg = r(B, S, 1, N).expand(B, S, G, N) if G > 1 else r(B, S, 2, N)[:, :,
                                                                     :1]
    _, cots = _k7b_inputs(B, S, H, P, N, Q, G, dev)
    got = ssd.ssd_intra_chunk_bwd(x, dt, A, Bg, Cg, Q, *cots)
    same = ssd.ssd_intra_chunk_bwd(x.contiguous(), dt.contiguous(),
                                   A.contiguous(), Bg.contiguous(),
                                   Cg.contiguous(), Q, *cots)
    for u, v in zip(got, same):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_k7_route_layer_grads_match_chunked(dev, monkeypatch):
    """One full-width mamba2-1.3b layer at the training call's shape (B 2,
    S 2048): its parameter gradients through the route (K7 + K7b) against
    autograd of ``_ssd_chunked``, each leaf to eps·max|grad| + 1e-5 of it,
    eps the K7b bound's factor at the layer's max|cum| (the fp32
    projections around the SSD add ~d·u, within the 1e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, ssm
    from repro_torch.utils.tree import tree_paths, tree_unflatten
    cfg = get_config("mamba2-1.3b")
    gen = torch.Generator(device=dev).manual_seed(5)
    p = ssm.init_mamba2(gen, cfg)
    u = torch.randn((2, 2048, cfg.d_model), generator=gen, device=dev)
    w = torch.randn((2, 2048, cfg.d_model), generator=gen, device=dev)
    calls = []
    real = ssm._takes_k7
    monkeypatch.setattr(ssm, "_takes_k7",
                        lambda *t: calls.append(real(*t)) or calls[-1])

    def grads(route):
        calls.clear()
        before = ssd.ssd_intra_chunk_bwd.launches
        paths = [(k, v.clone().requires_grad_()) for k, v in tree_paths(p)]
        if not route:
            monkeypatch.setattr(ssm, "_takes_k7", lambda *t: False)
        out = ssm.mamba2_forward(tree_unflatten(p, [v for _, v in paths]),
                                 cfg, u, torch.float32)
        g = torch.autograd.grad((out * w).sum(), [v for _, v in paths])
        torch.cuda.synchronize()
        return ({k: gi for (k, _), gi in zip(paths, g)},
                ssd.ssd_intra_chunk_bwd.launches - before)

    got, n_bwd = grads(True)
    assert calls == [True] and n_bwd == 1
    want, n_plain = grads(False)
    assert n_plain == 0
    s = cfg.ssm
    dt = ssm._softplus(layers.linear(p["wdt"], u, torch.float32)
                       + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    cmax = float((dt * A.abs()).reshape(2, 8, s.chunk, -1).sum(2).max())
    eps = 2.0 ** -24 * (4 * cmax + 2 * (s.d_state + s.chunk + s.head_dim
                                        + 64) + 8 * s.head_dim + 16)
    for k in want:
        tol = (eps + 1e-5) * float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= tol, k


@pytest.mark.cuda
def test_ssd_k7_counts_in_a_training_round(dev):
    """One round of the mamba2-1.3b training cell's job (24 layers at full
    width; savic, Adam D at sync, fused K1; M 2, H 2, b 2, S 2048) under
    the recorder: ``model.ssd_k7`` counts 192 routed calls (96 forward, 96
    remat recompute: M·H·24), K7 launches 192 times and K7b 96."""
    import sys
    import types

    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.utils import trace
    name = "mamba2-1.3b-24l"
    mod = types.ModuleType("repro_torch.configs.mamba2_1p3b_24l_cuda_test")
    mod.CONFIG = mod.REDUCED = configs.get_config("mamba2-1.3b").replace(
        n_layers=24)
    sys.modules[mod.__name__] = mod
    configs.register(name, mod.__name__.rsplit(".", 1)[1])
    run = train.setup(["--arch", name, "--device", "cuda", "--seed", "11",
                       "--dtype", "float32", "--method", "savic",
                       "--preconditioner", "adam", "--scaling", "global",
                       "--clients", "2", "--h-local", "2", "--batch", "2",
                       "--seq", "2048", "--use-fused-kernel"])
    batch = train.round_batch(run.loader, run.args, 0, run.device)
    k7, k7b = ssd.ssd_intra_chunk.launches, ssd.ssd_intra_chunk_bwd.launches
    with trace.recording() as rec:
        state, met = run.round_step(run.state, batch, run.stream(0))
        torch.cuda.synchronize()
    _, counters = rec.collect()
    assert counters[0]["model.ssd_k7"] == 192
    assert ssd.ssd_intra_chunk.launches - k7 == 192
    assert ssd.ssd_intra_chunk_bwd.launches - k7b == 96
    assert bool(torch.isfinite(met["loss"]).all())


@pytest.mark.cuda
def test_ssd_k7_takes_bf16_compute(dev, monkeypatch):
    """``--dtype bfloat16`` (bf16 compute on fp32 state) takes the route
    too: a round of reduced mamba2 (2 layers; M 2, H 2, b 2, S 64)
    counts ``model.ssd_k7`` 2·M·H·L = 16 (forward and remat recompute) and
    K7b M·H·L = 8; one full-width layer's parameter gradients in bf16
    through the route match the plain route's (``_takes_k7`` stubbed
    False) to 2^-5 of each leaf's largest: the routes differ only in the
    SSD's fp32 rounding, which a bf16 cast of y can move by one bf16 ulp
    (2^-8) of an element."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import ssm
    from repro_torch.utils import trace
    from repro_torch.utils.tree import tree_paths, tree_unflatten
    run = train.setup(["--arch", "mamba2-1.3b", "--reduced", "--device",
                       "cuda", "--seed", "13", "--dtype", "bfloat16",
                       "--method", "savic", "--clients", "2", "--h-local",
                       "2", "--batch", "2", "--seq", "64"])
    batch = train.round_batch(run.loader, run.args, 0, run.device)
    k7b = ssd.ssd_intra_chunk_bwd.launches
    with trace.recording() as rec:
        _, met = run.round_step(run.state, batch, run.stream(0))
        torch.cuda.synchronize()
    _, counters = rec.collect()
    assert counters[0]["model.ssd_k7"] == 16
    assert ssd.ssd_intra_chunk_bwd.launches - k7b == 8
    assert bool(torch.isfinite(met["loss"]).all())

    cfg = get_config("mamba2-1.3b")
    gen = torch.Generator(device=dev).manual_seed(6)
    p = ssm.init_mamba2(gen, cfg)
    u = torch.randn((2, 2048, cfg.d_model), generator=gen, device=dev)
    w = torch.randn((2, 2048, cfg.d_model), generator=gen, device=dev)

    def grads():
        paths = [(k, v.clone().requires_grad_()) for k, v in tree_paths(p)]
        with trace.recording() as r:
            out = ssm.mamba2_forward(tree_unflatten(p, [v for _, v in paths]),
                                     cfg, u, torch.bfloat16)
            g = torch.autograd.grad((out.float() * w).sum(),
                                    [v for _, v in paths])
        torch.cuda.synchronize()
        n = sum(c.get("model.ssd_k7", 0) for c in r.collect()[1].values())
        return {k: gi for (k, _), gi in zip(paths, g)}, n

    got, n_route = grads()
    monkeypatch.setattr(ssm, "_takes_k7", lambda *t: False)
    want, n_plain = grads()
    assert n_route == 1 and n_plain == 0
    for k in want:
        assert got[k].dtype == want[k].dtype
        tol = 2.0 ** -5 * float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= tol, k


def _k2_inputs(n, dev, seed=0, alpha=1e-2):
    """p, m, g ~ N(0, 1); d = |N(0, 1)| with every fifth element 0 and every
    seventh under α² (the clip is hit)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p, m, g = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    d = torch.randn(n, generator=gen, device=dev).abs_()
    d[::5] = 0.0
    d[1::7] = 0.25 * alpha ** 2
    return p, m, g, d


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [1e-3, 1e-2])
@pytest.mark.parametrize("beta1", [0.0, 0.9])
@pytest.mark.parametrize("squared", [True, False])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 127, 128, 129, 1 << 20,
                               (1 << 20) + 3])
def test_k2_bitwise_vs_plain(dev, n, squared, beta1, alpha):
    """Every residue of n mod 4 (float4 path with a masked tail on aligned
    tensors), both magnitudes, both β₁, two α floors: bitwise."""
    x = _k2_inputs(n, dev, seed=n, alpha=alpha)
    kw = dict(gamma=0.05, beta1=beta1, alpha=alpha, squared=squared)
    want = ref.scaled_update_ref(*x, **kw)
    before = su.scaled_update_flat.launches
    got = ops.scaled_update(*x, **kw)
    torch.cuda.synchronize()
    assert su.scaled_update_flat.launches == before + 1
    for w, g in zip(want, got):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4099])
def test_k2_scalar_path_on_misaligned_views(dev, n):
    """Views one float into a buffer are not 16-byte aligned: the scalar
    path, bitwise; NaN from a negative d under √ passes through."""
    x = list(_k2_inputs(n, dev, seed=1))
    x[3][:3] = -1.0
    views = []
    for t in x:
        buf = torch.empty(n + 1, device=dev)
        buf[1:] = t
        views.append(buf[1:])
    kw = dict(gamma=0.05, beta1=0.9, alpha=1e-2)
    want = ref.scaled_update_ref(*views, **kw)
    got = su.scaled_update_flat(*views, **kw)
    assert bool(torch.isnan(got[0][:3]).all())
    for w, g in zip(want, got):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_k2_tree_launches_once_per_leaf(dev):
    """``scaled_update_tree`` on the Fig. 1 MLP tree with a client dim: one
    K2 launch per leaf, each leaf bitwise its plain step."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {"w1": (10, 192, 128), "b1": (10, 128), "w2": (10, 128, 10),
              "b2": (10, 10)}
    mk = lambda: {k: torch.randn(s, generator=gen, device=dev)
                  for k, s in shapes.items()}
    params, mom, d = mk(), mk(), {k: v.abs() for k, v in mk().items()}
    before = su.scaled_update_flat.launches
    got = ops.scaled_update_tree(params, mom, d, 0.002, 1e-2)
    torch.cuda.synchronize()
    assert su.scaled_update_flat.launches == before + 4
    for k in shapes:
        want = ref.scaled_update_ref(
            params[k].reshape(-1), torch.zeros_like(mom[k]).reshape(-1),
            mom[k].reshape(-1), d[k].reshape(-1), gamma=0.002, beta1=0.0,
            alpha=1e-2)[0]
        assert torch.equal(got[k].reshape(-1), want), k


@pytest.mark.cuda
def test_k2_rejects_mixed_devices(dev):
    p, m, g, d = _k2_inputs(64, dev)
    with pytest.raises(ValueError, match="g is on"):
        su.scaled_update_flat(p, m, g.cpu(), d, gamma=0.1, beta1=0.9,
                              alpha=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("V,v_real,d", [(32768, 32000, 2560),
                                        (16384, 16000, 8192)])
def test_k6_wide_heads_vs_plain(dev, V, v_real, d, B, greedy):
    """d > 2048 (zamba2, gemma3, qwen3 at 2560; deepseek-67b at 8192): y is
    staged in slices over d; ids under the near-tie rule."""
    y, table, noise = _k6_inputs(B, V, d, dev, greedy)
    scale = d ** -0.5
    assert ds.sample_plan(B, d, v_real)[2] < d
    logits = ref.decode_sample_logits(y, table, noise, scale=scale,
                                      v_real=v_real)
    want = ref.decode_sample_ref(y, table, noise, scale=scale, v_real=v_real)
    got = ops.decode_sample(y, table, noise, scale=scale, v_real=v_real)
    torch.cuda.synchronize()
    ties, bad = ref.near_tie_check(logits, got, want, v_real)
    assert bad == 0 and ties <= 1, (ties, bad)


@pytest.mark.cuda
def test_fig1_short_run_on_cuda(dev):
    """Two Fig. 1 rounds of Adam (global) on the fused loop: K1 once a local
    step, finite losses, the tree loop within 1e-5."""
    from repro_torch.launch import paper
    su.fused_step_flat.launches = 0
    fused = paper.fig1_run(0.5, "Adam global", device="cuda", rounds=2,
                           use_fused_kernel=True)
    assert su.fused_step_flat.launches == 2 * paper.FIG1["h_local"]
    tree = paper.fig1_run(0.5, "Adam global", device="cuda", rounds=2)
    for f, t in zip(fused, tree):
        loss = f["metrics"]["loss"]
        assert loss == loss and abs(loss) < float("inf")
        assert abs(loss - t["metrics"]["loss"]) <= 1e-5 * abs(loss)


# --------------------------------------------------------------------------- #
# the hybrid's (zamba2-2.7b) and qwen3-4b's shapes: K4 and K5 at D = 80 with
# rep 1 (32 kv heads) and at D = 128 with rep 4, K6 at both heads, K7 at
# zamba2's (H 80, P 64, N 64, Q 256), each against its plain version
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hk,D", [(2, 512, 32, 32, 80),
                                        (1, 300, 32, 32, 80),
                                        (2, 512, 32, 8, 128)])
def test_k4_at_the_hybrid_and_qwen3_heads(dev, B, S, H, Hk, D):
    """D = 80 pads to the 128-wide tile (zamba2's shared block, rep 1);
    D = 128, rep 4 (qwen3); S cut from the serves' 2048 and 512."""
    q, k, v = _k4_inputs(B, S, H, Hk, D, torch.float32, dev)
    want = ref.flash_attention_ref(q, k, v)
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (B, S, H, D)
    assert float((got - want).abs().max()) <= _k4_bound(v)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("B,C,Hk,rep,D", [(4, 2112, 32, 1, 80),
                                          (8, 576, 8, 4, 128),
                                          (1, 4099, 32, 1, 80)])
def test_k5_at_the_hybrid_and_qwen3_heads(dev, B, C, Hk, rep, D, cap):
    """zamba2's decode (Hk 32, rep 1, D 80, C = 2048 + 64) and qwen3's
    (Hk 8, rep 4, D 128, C = 512 + 64); two launches a call."""
    q, k, v, bias = _k5_inputs(B, C, Hk, rep, D, dev)
    want = ref.decode_attention_ref(q, k, v, bias, softcap=cap)
    before = ds.decode_attention.launches
    got = ops.decode_attention(q, k, v, bias, softcap=cap)
    torch.cuda.synchronize()
    assert ds.decode_attention.launches == before + 2
    assert float((got - want).abs().max()) <= \
        1e-5 * float(v.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("B,V,v_real,d", [(4, 32768, 32000, 2560),
                                          (8, 32768, 32000, 2560),
                                          (8, 153600, 151936, 2560)])
def test_k6_at_the_hybrid_and_qwen3_heads(dev, B, V, v_real, d, greedy):
    y, table, noise = _k6_inputs(B, V, d, dev, greedy)
    scale = d ** -0.5
    logits = ref.decode_sample_logits(y, table, noise, scale=scale,
                                      v_real=v_real)
    want = ref.decode_sample_ref(y, table, noise, scale=scale, v_real=v_real)
    got = ops.decode_sample(y, table, noise, scale=scale, v_real=v_real)
    torch.cuda.synchronize()
    ties, bad = ref.near_tie_check(logits, got, want, v_real)
    assert bad == 0 and ties <= 1, (ties, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,a", [(4, 2048, None), (1, 256, None),
                                   (2, 512, -16.0)])
def test_k7_at_the_hybrid_shape(dev, B, S, a):
    """zamba2's SSD: 80 heads of P = 64, N = 64, Q = 256, one B/C group
    (head stride 0); the serve's prefill, one chunk, and A = -16."""
    H, P, N, Q = 80, 64, 64, 256
    x, dt, A, Bm, Cm = _k7_inputs(B, S, H, P, N, dev, a, True)
    want = ref.ssd_intra_chunk_ref(x, dt, A, Bm, Cm, Q)
    got = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    bounds, _ = k7_bounds(x, dt, A, Bm, Cm, Q)
    for g, w, bd in zip(got, want, bounds):
        assert bool(((g - w).abs() <= bd).all()), \
            float(((g - w).abs() / bd.clamp_min(1e-30)).max())
