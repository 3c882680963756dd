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
by at most 4u·max|cum| relative.
"""
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


# (B, S, H, P, N, Q, A, shared B/C): the serve prefill's shape with one
# B/C group over the heads (head stride 0), per-head B/C, Q 64/128 with N
# 16/64 and P 32/128, one chunk (the continuous-batching prefill), A = -16
# (max|cum| in the thousands), and ragged P, N and Q
K7_CASES = [(4, 2048, 64, 64, 128, 256, None, True),
            (2, 1024, 16, 64, 128, 256, None, False),
            (2, 512, 8, 32, 16, 64, None, False),
            (2, 512, 8, 128, 64, 128, None, False),
            (2, 512, 8, 128, 16, 64, None, True),
            (2, 512, 8, 32, 64, 128, None, True),
            (1, 256, 64, 64, 128, 256, None, True),
            (2, 1024, 8, 64, 128, 256, -16.0, True),
            (1, 144, 3, 30, 20, 48, None, False)]


def _k7_inputs(B, S, H, P, N, dev, a=None, shared=False, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = f(B, S, H, P)
    dt = torch.nn.functional.softplus(f(B, S, H))
    A = torch.full((H,), a, device=dev) if a is not None else -torch.exp(f(H))
    if shared:
        Bm, Cm = f(B, S, 1, N).expand(B, S, H, N), \
            f(B, S, 1, N).expand(B, S, H, N)
    else:
        Bm, Cm = f(B, S, H, N), f(B, S, H, N)
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
    """``ops.ssd`` (K7 + the inter-chunk recurrence, from an h0) against
    ``models.ssm.ssd_chunked`` on the card."""
    from repro_torch.models import ssm
    x, dt, A, Bm, Cm = _k7_inputs(2, 1024, 8, 64, 128, dev, shared=True)
    h0 = torch.randn((2, 8, 64, 128), device=dev)
    y, h = ops.ssd(x, dt, A, Bm, Cm, chunk=256, h0=h0)
    yw, hw = ssm.ssd_chunked(x, dt, A, Bm, Cm, 256, h0=h0)
    my, mh = ssm.ssd_chunked(x.abs(), dt, A, Bm.abs(), Cm.abs(), 256,
                             h0=h0.abs())
    cmax = float((dt * A.abs()).reshape(2, 4, 256, 8).sum(2).max())
    eps = 2.0 ** -24 * (4 * cmax + 2 * (128 + 256) + 32)
    assert bool(((y - yw).abs() <= eps * my).all())
    assert bool(((h - hw).abs() <= eps * mh).all())


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
    """``serve(use_ssd_kernel=True)`` on the card prefills through K7, one
    launch per layer, and decodes on K6."""
    from repro_torch.launch import serve
    ssd.ssd_intra_chunk.launches = 0
    ds.decode_sample.launches = 0
    res = serve.serve("mamba2-1.3b", reduced=True, batch=2, prompt_len=64,
                      gen_len=4, use_ssd_kernel=True, use_decode_kernel=True,
                      verbose=False, device="cuda")
    assert ssd.ssd_intra_chunk.launches == 2
    assert ds.decode_sample.launches == 3
    assert res.tokens.shape == (2, 4) and int(res.tokens.max()) < 512


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
