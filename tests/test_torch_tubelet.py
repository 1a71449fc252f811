"""Port tubelet embedding (``laryngeal_tpu_torch/ops/tubelet.py``) against
the JAX package's (``laryngeal_tpu/ops/tubelet.py``): the same numpy inputs,
made from a seed, go through both. On the CPU the port's kernel route runs
kernel 10's plain twin; the JAX Pallas kernel runs in interpret mode, as
``tests/test_tubelet.py`` runs it, with a block that does not divide M."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.models.vivit import create_vivit as jax_create_vivit
from laryngeal_tpu.ops import tubelet as jt
from laryngeal_tpu_torch.compat.flax_weights import vivit_state_dict_from_flax
from laryngeal_tpu_torch.models.vivit import create_vivit
from laryngeal_tpu_torch.ops import tubelet as tt

TOL = 1e-4  # tests/test_tubelet.py's f32 tolerance
JAX_ROUTES = {"conv": jt.tubelet_embed_conv, "matmul": jt.tubelet_embed_matmul,
              "kernel": functools.partial(jt.tubelet_embed_pallas, block_n=5)}  # M = 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    video = rng.standard_normal((2, 4, 32, 32, 3), dtype=np.float32)
    kernel = 0.05 * rng.standard_normal((2, 16, 16, 3, 48), dtype=np.float32)
    bias = rng.standard_normal(48, dtype=np.float32)
    return video, kernel, bias


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def test_extract_tubelets_token_order():
    video = np.arange(2 * 4 * 4, dtype=np.float32).reshape(1, 2, 4, 4, 1)
    want = np.asarray(jt.extract_tubelets(jnp.asarray(video), (2, 2, 2)))
    got = tt.extract_tubelets(torch.from_numpy(video), (2, 2, 2)).numpy()
    assert got.shape == (1, 4, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], [0, 1, 4, 5, 16, 17, 20, 21])


def test_kernel_layouts(data):
    _, kernel, _ = data
    np.testing.assert_array_equal(tt.flatten_kernel(torch.from_numpy(kernel)).numpy(),
                                  np.asarray(jt.flatten_kernel(jnp.asarray(kernel))))
    conv_weight = torch.from_numpy(kernel).permute(4, 3, 0, 1, 2)  # (D, C, kt, kh, kw)
    assert torch.equal(tt.kernel_from_conv3d(conv_weight), torch.from_numpy(kernel))


@pytest.mark.parametrize("impl", sorted(JAX_ROUTES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routes_match_jax(data, impl, dtype):
    """f32 to the JAX test's 1e-4. bf16: matmul and kernel round once, under
    kernel 10's limit (``tubelet.error_limit``); conv rounds the product to
    bf16 before it adds the bias, on both sides, so one more bf16 ulp of the
    product, 2^-7·|out - bias|, may separate them."""
    video, kernel, bias = data
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.array(JAX_ROUTES[impl](jnp.asarray(video, jdt), jnp.asarray(kernel),
                                     jnp.asarray(bias)).astype(jnp.float32))
    tv, tk, tb = _torch(video, kernel, bias)
    got = tt.tubelet_embed(tv.to(dtype), tk, tb, impl=impl)
    assert got.dtype == dtype and got.shape == (2, 8, 48)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
        return
    limit = tt.error_limit(tv.to(dtype), tk, got)
    if impl == "conv":
        limit = limit + 2.0 ** -7 * (got.float() - tb.to(dtype).float()).abs()
    assert ((got.float() - torch.from_numpy(want)).abs() / limit).max().item() <= 1.0


def test_plain_twin_rounds_the_bias_to_the_video_dtype(data):
    """Kernel 10 (and its twin) add the bias cast to the video's dtype; the
    matmul route adds it in f32."""
    video, kernel, bias = data
    tv, tk, tb = _torch(video, kernel, bias)
    tb = tb + 1e-3  # off the bf16 grid
    v16 = tv.to(torch.bfloat16)
    want = tt.tubelet_embed_matmul(v16, tk, tb.to(torch.bfloat16))
    assert torch.equal(tt.tubelet_embed_plain(v16, tk, tb), want)
    assert torch.equal(tt.tubelet_embed_plain(tv, tk, tb), tt.tubelet_embed_matmul(tv, tk, tb))


def test_vivit_stem_weights_carry_over(data):
    """JAX ViViT params -> compat.flax_weights -> the port model: its conv3d
    stem equals kernel 10's route fed ``kernel_from_conv3d`` of its weight,
    which is the Flax kernel itself, and the JAX model's own stem."""
    video, _, _ = data
    cfg = dict(num_frames=4, image_size=32, hidden_size=48, num_layers=1, num_heads=2,
               intermediate_size=96)
    model = jax_create_vivit(**cfg)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(1), jnp.asarray(video))["params"])
    proj = params["embeddings"]["projection"]
    proj["bias"] = proj["bias"] + np.linspace(-1, 1, 48, dtype=np.float32)  # nonzero
    port = create_vivit(seed=None, **cfg)
    port.load_state_dict(vivit_state_dict_from_flax(params))
    stem = port.vivit.embeddings.patch_embeddings
    kernel = tt.kernel_from_conv3d(stem.projection.weight.detach())
    np.testing.assert_array_equal(kernel.numpy(), proj["kernel"])
    tv = torch.from_numpy(video)
    with torch.no_grad():
        want = stem(tv)
        got = tt.tubelet_embed(tv, kernel, stem.projection.bias, impl="kernel")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    jax_stem = jt.tubelet_embed(jnp.asarray(video), jnp.asarray(proj["kernel"]),
                                jnp.asarray(proj["bias"]), impl="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_stem), atol=TOL, rtol=TOL)


def test_dispatch(data, monkeypatch):
    video, kernel, bias = _torch(*data)
    monkeypatch.delenv("LARYNGEAL_TUBELET_IMPL", raising=False)
    assert torch.equal(tt.tubelet_embed(video, kernel, bias),
                       tt.tubelet_embed_conv(video, kernel, bias))
    monkeypatch.setenv("LARYNGEAL_TUBELET_IMPL", "matmul")
    assert torch.equal(tt.tubelet_embed(video, kernel, bias),
                       tt.tubelet_embed_matmul(video, kernel, bias))
    monkeypatch.setenv("LARYNGEAL_TUBELET_IMPL", "pallas")  # the JAX name of the kernel route
    assert torch.equal(tt.tubelet_embed(video, kernel, bias),
                       tt.tubelet_embed_plain(video, kernel, bias))
    assert torch.equal(tt.tubelet_embed(video, kernel, bias, impl="conv"),
                       tt.tubelet_embed_conv(video, kernel, bias))
    monkeypatch.setenv("LARYNGEAL_TUBELET_IMPL", "magic")
    with pytest.raises(ValueError, match="Unknown tubelet impl"):
        tt.tubelet_embed(video, kernel, bias)
    with pytest.raises(ValueError, match="Unknown tubelet impl"):
        tt.tubelet_embed(video, kernel, bias, impl="xla")
    with pytest.raises(ValueError):
        tt.tubelet_embed(video[:, :3], kernel, bias, impl="kernel")  # T = 3, kt = 2


@pytest.mark.parametrize("tubelet,d", [((2, 8, 8), 48), ((2, 16, 16), 20)], ids=str)
def test_kernel_route_outside_the_kernels_shapes_matches_jax(data, tubelet, d):
    """kw·C = 24 and D = 20 are shapes no run-length instance of kernel 10
    takes; its general path does, as the JAX Pallas kernel takes any: on a
    CPU tensor the kernel route computes the twin, JAX's Pallas function, at
    the f32 tolerance."""
    video, _, _ = data
    rng = np.random.default_rng(1)
    kernel = 0.05 * rng.standard_normal((*tubelet, 3, d), dtype=np.float32)
    bias = rng.standard_normal(d, dtype=np.float32)
    tv, tk = torch.from_numpy(video), torch.from_numpy(kernel)
    assert tt.kernel_takes(tv, tk, tubelet) and not tt.run_length_takes(tv, tk, tubelet)
    want = np.asarray(jt.tubelet_embed_pallas(jnp.asarray(video), jnp.asarray(kernel),
                                              jnp.asarray(bias), tubelet, block_n=5))
    got = tt.tubelet_embed(*_torch(video, kernel, bias), tubelet, impl="kernel")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


# (video (B, T, H, W, C), tubelet, D, a run-length instance takes it)
TAKES_SHAPES = [((1, 4, 32, 48, 3), (2, 16, 16), 48, True),
                ((1, 4, 32, 48, 3), (2, 16, 16), 20, False),     # D % 8 != 0
                ((1, 4, 16, 16, 3), (2, 8, 8), 16, False),       # kw·C = 24
                ((1, 2, 21, 49, 3), (2, 7, 7), 16, False),       # W·C = 147, kw·C = 21
                ((1, 2, 16, 32, 4), (2, 16, 16), 8, True),       # kw·C = 64
                ((1, 2, 16, 32, 5), (2, 16, 16), 8, False),      # kw·C = 80
                ((1, 2, 8, 8, 1), (2, 8, 8), 8, False)]          # kw·C = 8


@pytest.mark.parametrize("shape,tubelet,d,run", TAKES_SHAPES, ids=str)
def test_kernel_takes_every_shape_that_fits_the_tubelet(shape, tubelet, d, run):
    """Kernel 10 takes every shape that fits the tubelet, as the JAX Pallas
    kernel (which pads M) does; the run-length instances take kw·C in
    RUN_LENGTHS with W·C and D multiples of 8, the general path the rest. A
    video that is not a whole number of tubelets, or a kernel of another
    tubelet, fits none."""
    video, kernel = torch.zeros(shape), torch.zeros((*tubelet, shape[-1], d))
    assert tt.kernel_takes(video, kernel, tubelet)
    assert tt.run_length_takes(video, kernel, tubelet) == run
    assert not tt.kernel_takes(video[:, :1], kernel, tubelet)
    assert not tt.kernel_takes(video, kernel[:, :1], tubelet)


@pytest.mark.parametrize("shape,tubelet,d", [((2, 2, 21, 49, 3), (2, 7, 7), 12),
                                             ((1, 4, 16, 32, 5), (2, 16, 16), 24)], ids=str)
def test_general_path_shapes_match_jax(shape, tubelet, d):
    """An odd W·C and kw·C = 80: the kernel route on CPU tensors (the twin
    the general path computes) matches JAX's ``tubelet_embed_pallas`` at the
    f32 tolerance, and in bf16 within ``tubelet.error_limit`` of JAX's bf16
    result."""
    rng = np.random.default_rng(2)
    video = rng.standard_normal(shape, dtype=np.float32)
    kernel = 0.05 * rng.standard_normal((*tubelet, shape[-1], d), dtype=np.float32)
    bias = rng.standard_normal(d, dtype=np.float32)
    want = np.asarray(jt.tubelet_embed_pallas(jnp.asarray(video), jnp.asarray(kernel),
                                              jnp.asarray(bias), tubelet, block_n=16))
    got = tt.tubelet_embed(*_torch(video, kernel, bias), tubelet, impl="kernel")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    v16 = torch.from_numpy(video).to(torch.bfloat16)
    got16 = tt.tubelet_embed(v16, torch.from_numpy(kernel), torch.from_numpy(bias), tubelet,
                             impl="kernel")
    want16 = np.asarray(jt.tubelet_embed_pallas(jnp.asarray(video, jnp.bfloat16),
                                                jnp.asarray(kernel), jnp.asarray(bias), tubelet,
                                                block_n=16), np.float32)
    limit = tt.error_limit(v16, torch.from_numpy(kernel), got16, tubelet)
    assert ((got16.float() - torch.from_numpy(want16)).abs() / limit).max() <= 1.0


def test_kernel_route_refuses_autograd_and_counts_no_cpu_launch(data):
    """Kernel 10 has no gradient, as the JAX Pallas route has none; conv and
    matmul stay differentiable. A CPU call is the twin and not a launch."""
    video, kernel, bias = _torch(*data)
    tt.reset_launches()
    leaf = kernel.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        tt.tubelet_embed(video, leaf, bias, impl="kernel")
    with torch.no_grad():
        tt.tubelet_embed(video, leaf, bias, impl="kernel")
    for impl in ("conv", "matmul"):
        leaf.grad = None
        tt.tubelet_embed(video, leaf, bias, impl=impl).sum().backward()
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    assert tt.launch_counts() == {"tubelet_embed": 0}
    with pytest.raises(ValueError, match="CUDA"):
        tt.tubelet_embed_cuda(video, kernel, bias)


# -- kernel 10's wgmma designs, emulated on the CPU ---------------------------

# (video shape, D, tubelet, dtype) -> the design the C entry runs: the wgmma
# designs at the run-length shapes, the general path off them.
DESIGN_CASES = [
    (((8, 32, 224, 224, 3), 768, (2, 16, 16), torch.bfloat16), "wgmma"),  # ViViT-B's stem
    (((8, 32, 224, 224, 3), 768, (2, 16, 16), torch.float32), "wgmma.tf32x3"),
    (((1, 4, 16, 32, 4), 32, (2, 4, 8), torch.bfloat16), "wgmma"),          # kw·C = 32
    (((1, 2, 32, 32, 4), 96, (2, 16, 16), torch.float32), "wgmma.tf32x3"),  # kw·C = 64
    (((1, 4, 16, 64, 1), 16, (4, 4, 16), torch.bfloat16), "wgmma"),         # kw·C = 16, kt = 4
    (((1, 5, 16, 64, 1), 16, (5, 4, 16), torch.bfloat16), "wgmma"),         # kt = 5
    (((1, 5, 16, 64, 1), 16, (5, 4, 16), torch.float32), "wgmma.tf32x3"),
    (((2, 4, 64, 64, 3), 96, (2, 8, 8), torch.bfloat16), "general"),        # kw·C = 24
    (((2, 4, 32, 48, 3), 100, (2, 16, 16), torch.float32), "general"),      # D % 8 != 0
    (((2, 4, 21, 49, 3), 64, (2, 7, 7), torch.bfloat16), "general"),        # W·C = 147
]


@pytest.mark.parametrize("case,want", DESIGN_CASES, ids=str)
def test_design_takes_mirrors_the_c_choice(case, want):
    """``design_takes`` names the design the C entry runs (held against
    ``tubelet_embed_design`` on the card): ``wgmma`` / ``wgmma.tf32x3`` at
    the run-length shapes, ``general`` elsewhere."""
    shape, d, tubelet, dtype = case
    assert tt.design_takes(shape, d, tubelet, dtype) == want
    video, kernel = torch.zeros(shape), torch.zeros((*tubelet, shape[-1], d))
    assert tt.run_length_takes(video, kernel, tubelet) == (want != "general")


def _tf32(x):
    """x rounded to TF32 to nearest, ties away from zero (``cvt.rna``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """``tf32tile::tf32_split``: big = x with its low 13 bits masked, small =
    tf32(x - big)."""
    big = (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, _tf32(x.float() - big)


def _emulate_wgmma(video, kernel, bias, tubelet, split="tf32x3"):
    """Kernel 10's wgmma designs on the CPU, in their schedule: 8 slots of 16
    rows a tile, a slot one h'-row's 16-patch chunk (rows past W' idle),
    slots walked in (b, t', h', chunk) order across clips and frame pairs,
    128-row tiles by 192 (bf16) or 128 (f32) columns of W^T; each K-step
    (dt, dh) one run of kw·C values a row. bf16 (``split`` None): the
    products summed in f32 over every step. f32: each step's products, three
    TF32 products (small·big, big·small, big·big; ``"tf32x3"``) or one of the
    operands rounded to TF32 (``"tf32"``), in a fresh accumulator added to
    the f32 sum. The bias is added in f32, the output rounded once; every
    token is written exactly once."""
    b, t, h, w, c = video.shape
    kt, kh, kw = tubelet
    run, d = kw * c, kernel.shape[-1]
    n_w, n_h, n_bt = w // kw, h // kh, b * (t // kt)
    n_wc = -(-n_w // 16)
    slots, bn = n_bt * n_h * n_wc, 128 if split else 192
    patches = tt.extract_tubelets(video, tubelet).reshape(-1, kt * kh * run).float()
    wt = tt.flatten_kernel(kernel).to(video.dtype).float().t()  # (D, K): the pre-pass
    parts = {"tf32x3": _split_tf32, "tf32": lambda x: (_tf32(x), None), None: None}[split]
    out = torch.zeros((patches.shape[0], d))
    written = torch.zeros(patches.shape[0], dtype=torch.int64)
    for slot0 in range(0, slots, 8):
        rows = []  # the tile's 128 rows: a token, or -1 for an idle row
        for slot in range(slot0, slot0 + 8):
            for i in range(16):
                wp = 16 * (slot % n_wc) + i
                rows.append((slot // n_wc) * n_w + wp if slot < slots and wp < n_w else -1)
        rows = torch.tensor(rows)
        live = rows >= 0
        a = torch.zeros((128, patches.shape[1]))
        a[live] = patches[rows[live]]
        for n0 in range(0, d, bn):
            bt = wt[n0:n0 + bn]
            total = torch.zeros((128, bt.shape[0]))
            for s in range(kt * kh):
                ak, bk = a[:, s * run:(s + 1) * run], bt[:, s * run:(s + 1) * run]
                if parts is None:
                    total += ak @ bk.t()
                    continue
                (a_big, a_small), (b_big, b_small) = parts(ak), parts(bk)
                step = a_big @ b_big.t()
                if a_small is not None:
                    step = a_small @ b_big.t() + a_big @ b_small.t() + step
                total += step
            out[rows[live], n0:n0 + bn] = total[live]
            written[rows[live]] += 1
    assert torch.equal(written, torch.full_like(written, -(-d // bn)))
    out = out + bias.to(video.dtype).float()
    return out.to(video.dtype).reshape(b, -1, d)


# (video (B, T, H, W, C), tubelet, D): kw·C = 48 with W' = 18 (two chunks a
# row) and 3 tiles, kw·C = 32 over 4 tiles, kw·C = 16 with kt = 4, kw·C = 64.
WGMMA_SHAPES = [((1, 4, 48, 288, 3), (2, 16, 16), 200),
                ((2, 4, 32, 64, 4), (2, 4, 8), 136),
                ((1, 8, 16, 64, 1), (4, 4, 16), 16),
                ((1, 2, 32, 64, 4), (2, 16, 16), 24)]


@pytest.mark.parametrize("shape,tubelet,d", WGMMA_SHAPES, ids=str)
def test_tf32x3_emulation_holds_the_f32_limit_where_one_term_does_not(shape, tubelet, d):
    """The f32 design (``wgmma.tf32x3``) emulated in its schedule stays within
    kernel 10's unchanged f32 limit (``error_limit``: 1e-5·Σ|x·w| + 1e-6) of
    the JAX package's Pallas kernel (interpret mode); one TF32 product of
    the rounded operands does not, which is why the split exists."""
    rng = np.random.default_rng(7)
    video = rng.standard_normal(shape, dtype=np.float32)
    fan_in = tubelet[0] * tubelet[1] * tubelet[2] * shape[-1]
    kernel = rng.standard_normal((*tubelet, shape[-1], d), dtype=np.float32) / np.sqrt(fan_in)
    bias = 0.1 * rng.standard_normal(d, dtype=np.float32)
    ref = torch.from_numpy(np.array(jt.tubelet_embed_pallas(
        jnp.asarray(video), jnp.asarray(kernel), jnp.asarray(bias), tubelet, block_n=64)))
    tv, tk, tb = _torch(video, kernel, bias)
    limit = tt.error_limit(tv, tk, ref, tubelet)
    emu = _emulate_wgmma(tv, tk, tb, tubelet, "tf32x3")
    assert ((emu - ref).abs() / limit).max().item() <= 0.25
    one = _emulate_wgmma(tv, tk, tb, tubelet, "tf32")
    assert ((one - ref).abs() / limit).max().item() > 1.0


@pytest.mark.parametrize("shape,tubelet,d", WGMMA_SHAPES, ids=str)
def test_bf16_wgmma_emulation_matches_jax_kernel(shape, tubelet, d):
    """The bf16 design (``wgmma``) emulated in its schedule (the tile walk,
    the idle rows, each token written once) matches the JAX package's
    Pallas kernel in bf16 (interpret mode) under ``error_limit``."""
    rng = np.random.default_rng(8)
    video = rng.standard_normal(shape, dtype=np.float32)
    fan_in = tubelet[0] * tubelet[1] * tubelet[2] * shape[-1]
    kernel = rng.standard_normal((*tubelet, shape[-1], d), dtype=np.float32) / np.sqrt(fan_in)
    bias = 0.1 * rng.standard_normal(d, dtype=np.float32)
    ref = torch.from_numpy(np.array(jt.tubelet_embed_pallas(
        jnp.asarray(video, jnp.bfloat16), jnp.asarray(kernel), jnp.asarray(bias), tubelet,
        block_n=64), np.float32))
    tv = torch.from_numpy(video).to(torch.bfloat16)
    tk, tb = _torch(kernel, bias)
    emu = _emulate_wgmma(tv, tk, tb, tubelet, None)
    limit = tt.error_limit(tv, tk, ref, tubelet)
    assert emu.dtype == torch.bfloat16
    assert ((emu.float() - ref).abs() / limit).max().item() <= 1.0
