"""The port's networks (blackbox_tpu_torch.models) against the JAX
package's flax models, on the CPU.

The JAX parameters come from the JAX package's ``init_params`` and are
carried across with ``from_jax_params``; inputs are numpy arrays from a
seed.  Logits agree to rtol/atol 1e-5; the U-Net's binned trail mask is
exact outside a |p - 0.5| <= 1e-4 band (XLA and PyTorch sum a
convolution in different orders); three Adam steps leave every
parameter within rtol 1e-4 of optax's.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import torch_parity  # noqa: E402,F401  (pins torch threads)
from torch_parity import assert_close, assert_exact  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackbox_tpu.models import trailnet as JT  # noqa: E402
from blackbox_tpu.models import vetnet as JV  # noqa: E402
from blackbox_tpu_torch.models import trailnet as TT  # noqa: E402
from blackbox_tpu_torch.models import vetnet as TV  # noqa: E402

BAND = 1e-4         # |p - 0.5| band excluded from the exact mask checks


def _unet(params):
    return TT.model_from(TT.from_jax_params(params), "cpu")


def _vetnet(params):
    m = TV.VetNet()
    m.load_state_dict(TV.from_jax_params(params))
    return m.eval()


@pytest.mark.parametrize("key, tile, batch", [(0, 32, 3), (1, 64, 2)])
def test_unet_logits_match_flax(key, tile, batch):
    params = JT.init_params(jax.random.PRNGKey(key), tile=tile)
    x = np.random.default_rng(key).normal(
        0, 1, (batch, tile, tile)).astype(np.float32)
    want = JT.TrailUNet().apply(params, jnp.asarray(x)[..., None])
    with torch.no_grad():
        got = _unet(params)(torch.from_numpy(x))
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key, n", [(0, 5), (3, 1)])
def test_vetnet_logits_match_flax(key, n):
    params = JV.init_params(jax.random.PRNGKey(key))
    x = np.random.default_rng(key).normal(
        0, 1, (n, JV.STAMP, JV.STAMP, 4)).astype(np.float32)
    want = JV.VetNet().apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = _vetnet(params)(torch.from_numpy(x))
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_state_dict_covers_every_flax_parameter():
    """from_jax_params fills every parameter of the modules, with the
    shapes of the port's own init_params, and nothing else."""
    gen = torch.Generator().manual_seed(0)
    for jmod, tmod in ((JT, TT), (JV, TV)):
        carried = tmod.from_jax_params(jmod.init_params(
            jax.random.PRNGKey(0)))
        own = tmod.init_params(gen)
        assert {k: tuple(v.shape) for k, v in carried.items()} == \
            {k: tuple(v.shape) for k, v in own.items()}
        for k, v in own.items():
            if k.endswith("bias"):
                assert not v.any(), k       # flax's zero bias init


def test_flax_transpose_conv_is_mirrored():
    """flax's ConvTranspose (transpose_kernel=False) correlates the
    dilated input with the kernel as stored; conv_transpose2d applies it
    mirrored, so the carried kernel is flipped in both spatial axes."""
    from flax import linen as nn
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (1, 3, 5, 2)).astype(np.float32)
    layer = nn.ConvTranspose(3, (2, 2), strides=(2, 2))
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    k = np.asarray(params["params"]["kernel"])           # (kh, kw, in, out)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def apply(w):
        return torch.nn.functional.conv_transpose2d(
            xt, torch.from_numpy(np.ascontiguousarray(w)),
            stride=2).permute(0, 2, 3, 1)

    carried = TT.from_jax_params({"ConvTranspose_0": {
        "kernel": k, "bias": np.zeros(3, np.float32)}})
    assert_close(apply(carried["ConvTranspose_0.weight"].numpy()), want,
                 rtol=1e-6, atol=1e-6)
    unflipped = apply(k.transpose(2, 3, 0, 1)).numpy()
    assert np.abs(unflipped - want).max() > 0.1


def _keras_file(path, params):
    """tests/test_trailnet.py's keras HDF5 export of flax params:
    transposed-conv kernels stored (kh, kw, out, in)."""
    import h5py
    from flax import traverse_util
    flat = traverse_util.flatten_dict(params["params"])
    kernels = sorted([kp for kp in flat if kp[-1] == "kernel"],
                     key=JT._layer_order)
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        names = []
        for i, kp in enumerate(kernels):
            is_tr = any(p.startswith("ConvTranspose") for p in kp)
            name = f"conv2d_transpose_{i}" if is_tr else f"conv2d_{i}"
            names.append(name.encode())
            g = root.create_group(name).create_group(name)
            kern = np.asarray(flat[kp])
            if is_tr:
                kern = np.swapaxes(kern, -1, -2)
            g.create_dataset("kernel:0", data=kern)
            g.create_dataset("bias:0",
                             data=np.asarray(flat[kp[:-1] + ("bias",)]))
        root.attrs["layer_names"] = names
    return path


def test_keras_round_trip_gives_jax_logits(tmp_path):
    """tests/test_trailnet.py:56's keras round trip, through the port:
    the converted state dict is the JAX conversion carried across, bit
    for bit, and gives JAX's logits."""
    pytest.importorskip("h5py")
    params = JT.init_params(jax.random.PRNGKey(3), tile=64)
    h5p = _keras_file(str(tmp_path / "asta.h5"), params)
    got = TT.convert_keras_weights(h5p)
    want = TT.from_jax_params(JT.convert_keras_weights(h5p, tile=64))
    assert got.keys() == want.keys()
    for k in want:
        assert_exact(got[k], want[k], k)
    x = np.random.default_rng(0).normal(0, 1, (1, 64, 64)).astype(
        np.float32)
    with torch.no_grad():
        logits = TT.model_from(got, "cpu")(torch.from_numpy(x))
    assert_close(logits, JT.TrailUNet().apply(params,
                                              jnp.asarray(x)[..., None]),
                 rtol=1e-5, atol=1e-5)


def test_keras_transpose_kernel_fault_is_matched(tmp_path):
    """A fault of the reference, matched: keras's Conv2DTranspose, like
    torch's, is the adjoint of a convolution (<conv(x, K), y> = <x,
    convT(y, K)>), so it applies its kernel mirrored relative to flax's
    unflipped ConvTranspose; convert_keras_weights swaps the channel
    axes but does not mirror, so a keras file runs with its transposed
    kernels mirrored.  The port's conversion reproduces the JAX
    package's network, not keras's."""
    pytest.importorskip("h5py")
    import torch.nn.functional as F
    rng = np.random.default_rng(6)
    # K: conv2d's weight (out 2, in 3, kh, kw), which is also the weight
    # of the transposed convolution from 2 channels back to 3
    K = torch.from_numpy(rng.normal(0, 1, (2, 3, 2, 2)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (1, 3, 8, 8)).astype(np.float32))
    y = torch.from_numpy(rng.normal(0, 1, (1, 2, 4, 4)).astype(np.float32))
    lhs = torch.sum(F.conv2d(x, K, stride=2) * y)
    rhs = torch.sum(x * F.conv_transpose2d(y, K, stride=2))
    assert abs(float(lhs - rhs)) < 1e-4 * abs(float(lhs))
    mirrored = torch.sum(x * F.conv_transpose2d(y, K.flip(2, 3), stride=2))
    assert abs(float(lhs - mirrored)) > 0.1

    params = JT.init_params(jax.random.PRNGKey(5), tile=32)
    h5p = _keras_file(str(tmp_path / "asta.h5"), params)
    ported = TT.convert_keras_weights(h5p)
    # keras's own semantics: the file's kernel applied unmirrored
    keras_like = dict(ported)
    for k in keras_like:
        if k.startswith("ConvTranspose") and k.endswith("weight"):
            keras_like[k] = keras_like[k].flip(2, 3)
    xin = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 32, 32)).astype(np.float32))
    jlog = JT.TrailUNet().apply(JT.convert_keras_weights(h5p, tile=32),
                                jnp.asarray(xin.numpy())[..., None])
    with torch.no_grad():
        got = TT.model_from(ported, "cpu")(xin)
        keras = TT.model_from(keras_like, "cpu")(xin)
    assert_close(got, jlog, rtol=1e-5, atol=1e-5)
    assert float((keras - got).abs().max()) > 1e-3


def test_keras_weights_need_h5py(monkeypatch, tmp_path):
    """Named for what it once held: the conversion needed h5py.  It now
    reads the file with the port's own HDF5 reader, so with h5py
    unimportable it gives the JAX package's conversion, bit for bit."""
    import sys
    pytest.importorskip("h5py")
    params = JT.init_params(jax.random.PRNGKey(3), tile=32)
    h5p = _keras_file(str(tmp_path / "asta.h5"), params)
    want = TT.from_jax_params(JT.convert_keras_weights(h5p, tile=32))
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = TT.convert_keras_weights(h5p)
    assert got.keys() == want.keys()
    for k in want:
        assert_exact(got[k], want[k], k)


def test_even_count_median_is_jax_median():
    """A tile's 256² and a stamp's 32² are even counts: jnp.median
    averages the two middle values, torch.median takes the lower one.
    The port's normalisations take JAX's median."""
    rng = np.random.default_rng(2)
    tiles = rng.normal(0, 1, (2, 256, 256)).astype(np.float32)
    tiles[1, :8] += 40.0
    got = TT._normalise(torch.from_numpy(tiles))
    want = jax.vmap(JT._normalise)(jnp.asarray(tiles))
    assert_close(got, want, rtol=1e-6, atol=1e-7)
    flat = torch.from_numpy(tiles[0]).reshape(-1)
    assert float(torch.median(flat)) != float(jnp.median(tiles[0]))
    stamps = rng.normal(0, 1, (3, 32, 32, 4)).astype(np.float32)
    assert_close(TV._norm(torch.from_numpy(stamps)),
                 JV._norm(jnp.asarray(stamps)), rtol=1e-6, atol=1e-7)


def _trail_frame(size=512, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(100.0, 3.0, (size, size)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    d = np.abs(0.6 * (yy - 30) - 0.8 * (xx - 10))
    return (img + 40.0 * np.exp(-0.5 * (d / 1.5) ** 2)).astype(np.float32)


def _sharp_params(img, key=0, frac=0.03):
    """JAX init params whose output layer is scaled up and shifted so
    that about ``frac`` of the binned frame passes the threshold: random
    weights leave every probability within ~0.05 of 0.5."""
    params = jax.tree_util.tree_map(np.array, JT.init_params(
        jax.random.PRNGKey(key)))
    head = params["params"]["Conv_0"]
    head["kernel"] *= 40.0
    head["bias"][:] = 0.0
    prob = TT.trail_probability(TT.from_jax_params(params),
                                torch.from_numpy(img))
    logit = torch.logit(prob.double()).numpy()
    head["bias"][:] = -np.quantile(logit, 1.0 - frac)
    return params


def test_segment_trails_matches_jax():
    """A 512² frame with a trail (bin 4, one 256² tile): the binned
    probabilities agree, the binned mask is exact outside the band
    around 0.5, and n_pix differs by at most the band's count."""
    img = _trail_frame()
    params = _sharp_params(img)
    sd = TT.from_jax_params(params)
    cfg = JT.TrailNetConfig()
    from blackbox_tpu.ops.satdet import _bin2d
    B = _bin2d(jnp.asarray(img), cfg.bin_factor)
    tile = jnp.pad(B, ((0, cfg.tile - B.shape[0]), (0, cfg.tile - B.shape[1])))
    jprob = np.asarray(jax.nn.sigmoid(JT.TrailUNet().apply(
        params, JT._normalise(tile)[None, ..., None])))[0][:B.shape[0],
                                                            :B.shape[1]]
    prob = TT.trail_probability(sd, torch.from_numpy(img))
    assert_close(prob, jprob, rtol=0, atol=1e-5)
    band = np.abs(jprob - 0.5) <= BAND
    np.testing.assert_array_equal((prob.numpy() > 0.5)[~band],
                                  (jprob > 0.5)[~band])

    want_mask, want_n = JT.segment_trails(params, jnp.asarray(img))
    got_mask, got_n = TT.segment_trails(sd, torch.from_numpy(img))
    assert 20 <= int(want_n) <= 0.2 * band.size
    assert abs(int(got_n) - int(want_n)) <= int(band.sum())
    inband = np.kron(band, np.ones((4, 4), bool))
    np.testing.assert_array_equal(got_mask.numpy()[~inband],
                                  np.asarray(want_mask)[~inband])
    print(f"band pixels: {int(band.sum())}, n_pix {int(got_n)}")


def test_area_filter_drops_small_components():
    """min_area drops components below it, with labels bounded at 64
    steps as in the JAX package: a 3-px blob goes, a 60-px bar stays."""
    m = np.zeros((40, 90), bool)
    m[5, 5:8] = True
    m[20, 10:70] = True
    got = TT.area_filter(torch.from_numpy(m), 40).numpy()
    from blackbox_tpu.ops.labeling import label_components
    lab = np.asarray(label_components(jnp.asarray(m), iters=64))
    areas = np.bincount(lab.ravel(), weights=m.ravel(), minlength=m.size + 2)
    np.testing.assert_array_equal(got, m & (areas[lab] >= 40))
    assert got[20].sum() == 60 and not got[5].any()


def _maps(seed, H=96, W=128):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (H, W)).astype(np.float32) for _ in range(4)]


def test_make_stamps_exact():
    """Clipped, rounded corners (half-integers round to even, as
    jnp.round does) and one window a candidate, bit for bit."""
    imgs = _maps(0)
    xs = np.array([0.0, 10.5, 11.5, 64.2, 127.0, 200.0], np.float32)
    ys = np.array([-5.0, 30.5, 31.5, 48.0, 95.0, 2.0], np.float32)
    want = JV.make_stamps(*map(jnp.asarray, imgs), jnp.asarray(xs),
                          jnp.asarray(ys))
    got = TV.make_stamps(*map(torch.from_numpy, imgs), xs, ys)
    assert_exact(got, want)


def test_score_transients_matches_jax():
    params = JV.init_params(jax.random.PRNGKey(7))
    imgs = _maps(1)
    xs = np.array([20.0, 64.0, 120.0, 3.0], np.float32)
    ys = np.array([30.0, 64.0, 5.0, 90.0], np.float32)
    want = JV.score_transients(params, *map(jnp.asarray, imgs),
                               jnp.asarray(xs), jnp.asarray(ys))
    got = TV.score_transients(TV.from_jax_params(params),
                              *map(torch.from_numpy, imgs), xs, ys)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def _optax_steps(jmod, model, params, norm, batches, lr, steps):
    """The JAX package's train step (optax.adam on the mean sigmoid
    cross-entropy), from given params."""
    import optax
    opt = optax.adam(lr)
    state = opt.init(params)

    @jax.jit
    def step(params, state, x, y):
        def loss_fn(p):
            return optax.sigmoid_binary_cross_entropy(
                model.apply(p, norm(x)), y).mean()
        grads = jax.grad(loss_fn)(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state

    for _ in range(steps):
        x, y = batches()
        params, state = step(params, state, jnp.asarray(x), jnp.asarray(y))
    return params


def _jax_norm_tiles(x):
    med = jnp.median(x, axis=(1, 2), keepdims=True)
    mad = jnp.median(jnp.abs(x - med), axis=(1, 2),
                     keepdims=True) * 1.4826 + 1e-6
    return (jnp.clip((x - med) / mad, -5.0, 25.0) / 25.0)[..., None]


@pytest.mark.parametrize("net", ["trailnet", "vetnet"])
def test_adam_steps_match_optax(net):
    """Three Adam steps from the same params on the same synth_batch
    draws: every parameter within rtol 1e-4 of optax's."""
    seed, steps = 5, 3
    if net == "trailnet":
        p0 = JT.init_params(jax.random.PRNGKey(seed), tile=64)
        rng = np.random.default_rng(seed)
        want = _optax_steps(JT, JT.TrailUNet(), p0, _jax_norm_tiles,
                            lambda: JT.synth_batch(rng, 2, 64), 3e-4, steps)
        got = TT.train(steps=steps, batch=2, size=64, seed=seed,
                       log_every=0, device="cpu",
                       params=TT.from_jax_params(p0))
    else:
        p0 = JV.init_params(jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)
        want = _optax_steps(JV, JV.VetNet(), p0, JV._norm,
                            lambda: JV.synth_batch(rng, 8), 1e-3, steps)
        got = TV.train(steps=steps, batch=8, seed=seed, log_every=0,
                       device="cpu", params=TV.from_jax_params(p0))
    # rtol 1e-4 of each parameter, floored at 1e-4 of the most Adam can
    # move it (lr a step): a weight that happens to lie near 0 has no
    # relative scale of its own
    lr = 3e-4 if net == "trailnet" else 1e-3
    want = TT.from_jax_params(want)
    start = TT.from_jax_params(p0)
    assert all(not torch.equal(got[k], start[k]) for k in want
               if k.endswith("bias"))
    for k in want:
        assert_close(got[k], want[k], rtol=1e-4, atol=1e-4 * lr * steps,
                     what=k)


@pytest.mark.parametrize("mod", [TT, TV], ids=["trailnet", "vetnet"])
def test_save_load_round_trip(mod, tmp_path):
    params = mod.init_params(torch.Generator().manual_seed(1))
    p = str(tmp_path / "net.pt")
    mod.save_params(p, params)
    back = mod.load_params(p)
    assert back.keys() == params.keys()
    for k in params:
        assert_exact(back[k], params[k], k)


def test_trailnet_synth_batch_matches_jax():
    want = JT.synth_batch(np.random.default_rng(9), 3, size=64)
    got = TT.synth_batch(np.random.default_rng(9), 3, size=64)
    for g, w in zip(got, want):
        assert_exact(g, w)


def test_vetnet_synth_batch_matches_jax():
    want = JV.synth_batch(np.random.default_rng(9), 20)
    got = TV.synth_batch(np.random.default_rng(9), 20)
    for g, w in zip(got, want):
        assert_exact(g, w)
