"""Flash attention: the port's ``ops.flash_attention`` on the CPU (the
kernel's plain version) against the JAX Pallas kernel in interpret mode,
its lane mask, its recompute backward, and the no-fallback rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_fwd as j_fa_fwd
from repro.models import attention as jattn
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention
from repro_torch.models.model import Model

# f32: both sides compute in f32 with different summation orders (2e-5 is
# the reference's own kernel-vs-oracle bound, tests/test_kernels.py:15).
# bf16: both compute in f32 from the same bf16 inputs and round the output
# to bf16, so one side may land one bf16 ulp (2^-8 relative) away.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# gradients: recompute through sdpa_chunked on both sides, f32, but summed
# over Sq or Sk terms — the reference's own grad test uses 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

GRID = [
    (2, 128, 128, 4, 2, 64, True, 0),       # GQA causal
    (1, 256, 256, 4, 4, 32, False, 0),      # MHA bidir
    (2, 96, 96, 2, 1, 64, True, 32),        # MQA + sliding window
    (1, 200, 200, 4, 2, 128, True, 0),      # non-block-multiple seq
    (1, 64, 192, 8, 8, 64, False, 0),       # cross-length
]
# beyond the reference's grid: a window without causality, and Sq > Sk
EXTRA = [
    (1, 100, 100, 4, 2, 64, False, 24),
    (2, 130, 70, 4, 2, 128, True, 0),
]


def _inputs(seed, B, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def _both(arrays, dtype):
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", GRID + EXTRA)
def test_flash_attention_matches_pallas_kernel(B, Sq, Sk, Hq, Hkv, D, causal,
                                               window, dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(Sq + Hq + D, B, Sq, Sk, Hq, Hkv,
                                            D), dtype)
    expect = j_fa_fwd(jq, jk, jv, causal=causal, window=window,
                      interpret=True)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(_np(out), _np(expect), **TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", GRID + EXTRA)
def test_plain_version_matches_oracle(B, Sq, Sk, Hq, Hkv, D, causal, window):
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(7, B, Sq, Sk, Hq, Hkv, D))
    np.testing.assert_allclose(
        _np(fa.flash_attention_plain(q, k, v, causal=causal, window=window)),
        _np(ref.attention_ref(q, k, v, causal=causal, window=window)),
        **TOL["float32"])


@pytest.mark.parametrize("active", [[1, 0, 1, 0], [0, 0, 1, 1], [1, 1, 1, 1]])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_lane_mask_exact_zeros_and_bit_identical(active, causal, window):
    (jq, jk, jv), (q, k, v) = _both(_inputs(3, 4, 64, 64, 4, 2, 64),
                                    "float32")
    dense = ops.flash_attention(q, k, v, causal=causal, window=window)
    masked = ops.flash_attention(q, k, v, causal=causal, window=window,
                                 active=torch.tensor(active))
    for lane, a in enumerate(active):
        if a:
            assert torch.equal(masked[lane], dense[lane])
        else:
            assert torch.equal(masked[lane], torch.zeros_like(masked[lane]))
    expect = j_fa_fwd(jq, jk, jv, causal=causal, window=window,
                      active=jnp.asarray(active, jnp.int32), interpret=True)
    np.testing.assert_allclose(_np(masked), _np(expect), **TOL["float32"])


@pytest.mark.parametrize("active", [None, [1, 0]])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16)])
def test_gradient_matches_reference(causal, window, active):
    """The port's autograd.Function (recompute through its sdpa_chunked)
    against jax.grad of the reference's custom_vjp."""
    arrays = _inputs(11, 2, 48, 48, 4, 2, 32)
    gw = np.random.default_rng(12).standard_normal(
        (2, 48, 4, 32)).astype(np.float32)
    j_act = None if active is None else jnp.asarray(active, jnp.int32)

    def f_ref(q, k, v):
        out = jops.flash_attention(q, k, v, causal, window, True,
                                   active=j_act)
        return (out * gw).sum()

    expect = jax.grad(f_ref, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = ops.flash_attention(q, k, v, causal, window,
                              active=None if active is None
                              else torch.tensor(active))
    (out * torch.from_numpy(gw)).sum().backward()
    for got, want in zip((q.grad, k.grad, v.grad), expect):
        np.testing.assert_allclose(_np(got), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("causal,window,q_offset,valid_len", [
    (True, 0, 0, None), (False, 0, 0, None), (True, 8, 0, None),
    (True, 0, 5, [20, 33]),
])
def test_sdpa_chunked_matches_reference(causal, window, q_offset, valid_len):
    arrays = _inputs(5, 2, 24, 40, 4, 2, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk_k=16)
    expect = jattn.sdpa_chunked(
        *(jnp.asarray(a) for a in arrays), **kw,
        kv_valid_len=None if valid_len is None
        else jnp.asarray(valid_len, jnp.int32))
    out = attention.sdpa_chunked(
        *(torch.from_numpy(a) for a in arrays), **kw,
        kv_valid_len=None if valid_len is None
        else torch.tensor(valid_len, dtype=torch.int32))
    np.testing.assert_allclose(_np(out), _np(expect), **TOL["float32"])


def test_sdpa_decode_matches_reference():
    q, kc, vc = _inputs(9, 3, 1, 20, 4, 2, 16)
    valid = np.random.default_rng(10).random((3, 20)) < 0.7
    valid[:, 0] = True
    expect = jattn.sdpa_decode(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(valid))
    out = attention.sdpa_decode(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), torch.from_numpy(valid))
    np.testing.assert_allclose(_np(out), _np(expect), **TOL["float32"])


def _cuda_model():
    Model(configs.get("stablelm-1.6b").reduced())


def _cuda_model_explicit():
    Model(configs.get("stablelm-1.6b").reduced(), device="cuda")


def _kernel_on_cpu_tensors():
    q = torch.zeros(1, 64, 2, 64)
    fa.flash_attention_cuda(q, q, q)


def _kernel_on_meta_tensors():
    q = torch.zeros(1, 64, 2, 64, device="meta")
    ops.flash_attention(q, q, q)


@pytest.mark.parametrize("call,exc", [
    (_cuda_model, RuntimeError),
    (_cuda_model_explicit, RuntimeError),
    (_kernel_on_cpu_tensors, ValueError),
    (_kernel_on_meta_tensors, ValueError),
])
def test_no_card_raises_instead_of_falling_back(call, exc):
    """Without a card, a call that asks for the GPU (or defaults to it) or
    hands the kernel tensors it cannot take raises; nothing runs quietly on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("dtype,D,body", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float16, 64, None), (torch.float64, 128, None),
    (torch.bfloat16, 32, None), (torch.float32, 96, None),
])
def test_attention_body_by_dtype_and_head_dim(dtype, D, body):
    """bf16 runs the tensor-core body, f32 the CUDA-core body (no TF32),
    head dims 64 and 128 only; anything else has no body and raises."""
    if body is None:
        with pytest.raises(ValueError, match="no kernel body|head dim"):
            fa.attention_body(dtype, D)
    else:
        assert fa.attention_body(dtype, D) == body
    assert set(fa.flash_attention_cuda.launches_by_body) == {"wgmma", "simt"}


def test_tma_strides_of_q_k_v():
    """The bf16 body's tensor maps take (b, s, h) strides in elements: a
    contiguous (B,S,H,D) tensor's own, a length-1 batch axis's replaced by
    one a map accepts; a base that is not 16-byte aligned raises, since no
    other body may take a bf16 input."""
    q = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16)
    assert fa._tma_strides(q) == q.stride()[:3]
    one = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    sb, ss, sh = fa._tma_strides(one)
    assert (ss, sh) == (256, 64) and sb % 8 == 0
    heads = torch.zeros(1, 64, 6, 64, dtype=torch.bfloat16)[:, :, 1:5]
    assert fa._tma_strides(heads)[1:] == (384, 64)
    flat = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._tma_strides(flat.view(2, 64, 4, 64))


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """With no library built and no nvcc on the machine, building raises
    (it never leaves the CUDA path without its kernel)."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_attention")
    assert not (tmp_path / "kernels").exists()


def test_library_name_tracks_source_and_flags(monkeypatch):
    from repro_torch.kernels import _build
    path = _build.library_path("flash_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("flash_attention") != path
