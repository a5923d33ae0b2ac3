"""Import and copy guards of the PyTorch port (blackbox_tpu_torch).

The port must run where jax is not installed, so it imports nothing of
jax, and carries copies of the few pure-Python pieces of blackbox_tpu
its slice needs (importing anything from blackbox_tpu imports jax).
These tests hold each copy equal to its original.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (pins torch threads)

SLICE_MODULES = [
    "blackbox_tpu_torch",
    "blackbox_tpu_torch.config",
    "blackbox_tpu_torch.kernels",
    "blackbox_tpu_torch.core.geometry",
    "blackbox_tpu_torch.core.maskbits",
    "blackbox_tpu_torch.ops.stats",
    "blackbox_tpu_torch.ops.polyfit",
    "blackbox_tpu_torch.ops.gain",
    "blackbox_tpu_torch.ops.overscan",
    "blackbox_tpu_torch.ops.morphology",
    "blackbox_tpu_torch.ops.masking",
    "blackbox_tpu_torch.ops.labeling",
    "blackbox_tpu_torch.ops.filters",
    "blackbox_tpu_torch.ops.cosmics",
    "blackbox_tpu_torch.ops.lacosmic_fused",
    "blackbox_tpu_torch.ops.nonlin",
    "blackbox_tpu_torch.ops.flatstats",
    "blackbox_tpu_torch.ops.upsample",
    "blackbox_tpu_torch.ops.xtalk",
    "blackbox_tpu_torch.ops.satdet",
    "blackbox_tpu_torch.ops.background",
    "blackbox_tpu_torch.ops.windows",
    "blackbox_tpu_torch.ops.detection",
    "blackbox_tpu_torch.ops.photometry",
    "blackbox_tpu_torch.ops.psf",
    "blackbox_tpu_torch.ops.fft",
    "blackbox_tpu_torch.ops.warp",
    "blackbox_tpu_torch.ops.zogy",
    "blackbox_tpu_torch.ops.transients",
    "blackbox_tpu_torch.pipeline.masters",
    "blackbox_tpu_torch.pipeline.reduce",
    "blackbox_tpu_torch.pipeline.subtract",
    "blackbox_tpu_torch.synth.device",
    "blackbox_tpu_torch.synth.generator",
    "blackbox_tpu_torch.synth.observation",
    "blackbox_tpu_torch.config.base",
    "blackbox_tpu_torch.config.defaults",
    "blackbox_tpu_torch.astro.wcs",
    "blackbox_tpu_torch.astro.photcal",
    "blackbox_tpu_torch.astro.time",
    "blackbox_tpu_torch.astro.ephem",
    "blackbox_tpu_torch.astro.vsop87",
    "blackbox_tpu_torch.astro.astrometry",
    "blackbox_tpu_torch.io.storage",
    "blackbox_tpu_torch.io.fits",
    "blackbox_tpu_torch.io.rice",
    "blackbox_tpu_torch.io.psffits",
    "blackbox_tpu_torch.qc",
    "blackbox_tpu_torch.qc.ranges",
    "blackbox_tpu_torch.qc.engine",
    "blackbox_tpu_torch.orchestration.paths",
    "blackbox_tpu_torch.orchestration.manifest",
    "blackbox_tpu_torch.orchestration.headertable",
    "blackbox_tpu_torch.orchestration.masterstore",
    "blackbox_tpu_torch.utils.locks",
    "blackbox_tpu_torch.utils.timing",
    "blackbox_tpu_torch.pipeline.headers",
    "blackbox_tpu_torch.pipeline.catalogs",
    "blackbox_tpu_torch.pipeline.driver",
    "blackbox_tpu_torch.report.quicklook",
    "blackbox_tpu_torch.ops.coadd",
    "blackbox_tpu_torch.pipeline.buildref",
    "blackbox_tpu_torch.sso",
    "blackbox_tpu_torch.sso.match",
    "blackbox_tpu_torch.sso.mpcorb",
    "blackbox_tpu_torch.astro.blindsolve",
    "blackbox_tpu_torch.orchestration.ingest",
    "blackbox_tpu_torch.orchestration.scheduler",
    "blackbox_tpu_torch.report.obslog",
    "blackbox_tpu_torch.__main__",
    "blackbox_tpu_torch.models",
    "blackbox_tpu_torch.models.trailnet",
    "blackbox_tpu_torch.models.vetnet",
    "blackbox_tpu_torch.report.finding_chart",
    "blackbox_tpu_torch.orchestration.cluster",
    "blackbox_tpu_torch.orchestration.pubsub",
    "blackbox_tpu_torch.io.fakegcs",
    "blackbox_tpu_torch.utils.watchdog",
    "blackbox_tpu_torch.parallel",
    "blackbox_tpu_torch.parallel.mesh",
    "blackbox_tpu_torch.parallel.extract",
    "blackbox_tpu_torch.parallel.distributed",
    "blackbox_tpu_torch.parallel.dryrun",
    "blackbox_tpu_torch.io.flaxmsgpack",
    "blackbox_tpu_torch.io.hdf5",
]

# Host modules copied from blackbox_tpu, by dotted path under each
# package, with the functions (``Class.method`` for methods) that
# differ on purpose and why.  Everything else, docstrings and comments
# aside, must be the original after the ``blackbox_tpu.`` ->
# ``blackbox_tpu_torch.`` import rewrite.
HOST_COPIES = {
    "astro.wcs": {}, "astro.photcal": {}, "astro.time": {},
    "astro.ephem": {}, "astro.vsop87": {}, "astro.astrometry": {},
    "config.base": {}, "config.defaults": {},
    "io.storage": {}, "io.fits": {},
    "io.rice": {
        "_build_lib": "builds into the package's _build/, never into the "
                      "source tree, under a private name renamed into "
                      "place",
        "coder": "reports which coder (compiled or numpy) is loaded"},
    "io.psffits": {
        "psf_to_hdu": "reads the model's tensors, which may lie on the "
                      "card",
        "read_psf": "returns the port's PSFModel on a given device"},
    "qc": {}, "qc.ranges": {}, "qc.engine": {},
    "orchestration.paths": {}, "orchestration.manifest": {},
    "orchestration.headertable": {},
    "orchestration.masterstore": {
        "MasterStore.__init__": "takes the device the masters are "
                                "stacked on",
        "MasterStore._build": "stacks the frames on that device with the "
                              "port's pipeline.masters"},
    "utils.locks": {},
    "utils.timing": {
        "device_memory_stats": "reads PyTorch's CUDA allocator",
        "timer": "synchronises a CUDA device; can sum spans into a dict; "
                 "is a span inside a recording",
        "profile_trace": "torch.profiler instead of jax.profiler",
        "_NullSpan": "the port's spans and counters (none in the JAX "
                     "package)",
        "Span": "the port's spans and counters",
        "Recorder": "the port's spans and counters",
        "span": "the port's spans and counters",
        "annotate": "the port's spans and counters",
        "count": "the port's spans and counters",
        "recording": "the port's spans and counters"},
    "pipeline.headers": {},
    "pipeline.catalogs": {
        "device_cat_to_columns": "moves the catalog's tensors to the host "
                                 "first"},
    "report.quicklook": {},
    "synth.generator": {}, "synth.observation": {},
    "sso": {}, "sso.match": {}, "sso.mpcorb": {},
    "astro.blindsolve": {
        "_build_lib": "builds into the package's _build/, never into the "
                      "source tree, under a private name renamed into "
                      "place"},
    "orchestration.ingest": {},
    "orchestration.scheduler": {
        "RunReport": "counts the frames of a failed device batch that "
                     "fell back to the per-frame path",
        "_run_batched_objects": "splits each chunk over the cards with "
                                "the port's map_batch (PyTorch runs "
                                "eagerly: no jit or shard_map) and counts "
                                "fallbacks"},
    "report.obslog": {},
    "__main__": {
        "build_parser": "the program's name and description",
        "main": "takes the device the pixel work runs on and hands it "
                "to the pipeline, the co-add and the finding chart"},
    "orchestration.cluster": {
        "sbatch_script": "a job runs the port's command line",
        "run_night_chain": "the night's jobs run the port's command line"},
    "orchestration.pubsub": {}, "io.fakegcs": {}, "utils.watchdog": {},
    "report.finding_chart": {
        "orient_data": "resamples with the port's lanczos_resample on a "
                       "given device",
        "finding_chart": "passes the device to orient_data",
        "chart_from_product": "passes the device to finding_chart"},
}

# single host functions copied into modules of the port that are not
# copies as a whole: (module, function)
HOST_FUNCTIONS = [
    ("ops.warp", "remap_grid"), ("ops.warp", "remap_grid_coarse"),
    ("ops.warp", "grid_shift_ranges"), ("ops.warp", "grid_row_margin"),
    ("ops.xtalk", "load_coeff_file"),
    ("ops.nonlin", "convert_reference_splines"),
    ("ops.nonlin", "convert_reference_splines_to_npy"),
    ("pipeline.subtract", "_measure_scaling"),
    ("ops.coadd", "ClipParams"), ("ops.coadd", "a_swarp_search"),
    ("pipeline.buildref", "BuildRefSettings"),
    ("pipeline.buildref", "select_images"),
    ("pipeline.buildref", "choose_clip_params"),
    ("models.trailnet", "TrailNetConfig"),
    ("models.trailnet", "synth_batch"), ("models.trailnet", "_layer_order"),
    ("models.vetnet", "_gauss"), ("models.vetnet", "synth_batch"),
    ("parallel.distributed", "_first_host"),
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m in ('jax', 'blackbox_tpu', 'flax', 'msgpack',\n"
            "                      'h5py')\n"
            "             or m.startswith(('jax.', 'jaxlib', 'blackbox_tpu.',\n"
            "                              'flax.', 'msgpack.', 'h5py.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("name", ["MEERLICHT", "TINY"])
def test_geometry_copy(name):
    from blackbox_tpu.core import geometry as jg
    from blackbox_tpu_torch.core import geometry as tg
    want = getattr(jg, name)
    got = getattr(tg, name)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("n_chan", "dy", "dx", "raw_shape", "red_shape",
                 "chan_shape", "os_vert_width", "os_hori_height"):
        assert getattr(got, prop) == getattr(want, prop), prop
    # the host slice tables: equal tuples of (row, column) slices
    for table in ("chan_sec", "data_sec", "os_sec_vert", "os_sec_hori",
                  "data_sec_red"):
        assert getattr(got, table) == getattr(want, table), table
    for iy in range(got.ny):
        assert got._data_y0(iy) == want._data_y0(iy), iy
    assert got.chan_is_top.dtype == want.chan_is_top.dtype
    assert np.array_equal(got.chan_is_top, want.chan_is_top)


def _clip_sample():
    """Gaussian rows with high and low outliers, a random mask and an
    all-masked row (seed 7)."""
    rng = np.random.default_rng(7)
    x = rng.normal(10.0, 3.0, (6, 257)).astype(np.float32)
    x[:, :9] += 60.0
    x[:, 9:14] -= 25.0
    mask = rng.random(x.shape) > 0.8
    mask[2] = True
    return x, mask


@pytest.mark.parametrize("axis", [None, 1])
@pytest.mark.parametrize("cenfunc", ["mean", "median"])
@pytest.mark.parametrize("lower,upper", [(None, None), (2.0, 4.0),
                                         (4.0, 1.5)])
def test_sigma_clip_options_match_jax(lower, upper, cenfunc, axis):
    """sigma_clip's asymmetric bounds and both centres: the exclusion
    masks equal the JAX package's bit for bit; sigma_clipped_mean_std
    with either ddof at rtol 1e-5 (the two frameworks sum in other
    orders); the defaults give what the explicit symmetric call gives,
    bit for bit."""
    import jax.numpy as jnp
    import torch
    from blackbox_tpu.ops import stats as js
    from blackbox_tpu_torch.ops import stats as ts
    x, mask = _clip_sample()
    kw = dict(axis=axis, sigma=2.5, sigma_lower=lower, sigma_upper=upper,
              cenfunc=cenfunc)
    got = ts.sigma_clip(torch.from_numpy(x), torch.from_numpy(mask), **kw)
    want = js.sigma_clip(jnp.asarray(x), jnp.asarray(mask), **kw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if lower is None:
        same = ts.sigma_clip(torch.from_numpy(x), torch.from_numpy(mask),
                             axis=axis, sigma=2.5, sigma_lower=2.5,
                             sigma_upper=2.5, cenfunc=cenfunc)
        assert torch.equal(got, same)
    for ddof in (0, 1):
        g = ts.sigma_clipped_mean_std(torch.from_numpy(x),
                                      torch.from_numpy(mask), axis=axis,
                                      sigma=2.5, cenfunc=cenfunc,
                                      std_ddof=ddof)
        w = js.sigma_clipped_mean_std(jnp.asarray(x), jnp.asarray(mask),
                                      axis=axis, sigma=2.5, cenfunc=cenfunc,
                                      std_ddof=ddof)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       err_msg=f"ddof {ddof}")
    if cenfunc == "mean":
        # the defaults (cenfunc "mean", ddof 0) are today's call
        d = ts.sigma_clipped_mean_std(torch.from_numpy(x),
                                      torch.from_numpy(mask), axis=axis,
                                      sigma=2.5)
        m = ts.sigma_clip(torch.from_numpy(x), torch.from_numpy(mask),
                          axis=axis, sigma=2.5)
        for a, b in zip(d, ts.masked_mean_std(torch.from_numpy(x), m,
                                              axis=axis)):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_maskbits_copy():
    from blackbox_tpu.core import maskbits as jm
    from blackbox_tpu_torch.core import maskbits as tm
    for name in ("BAD", "COSMIC", "SATURATED", "SAT_CONNECTED", "SATELLITE",
                 "EDGE", "CROSSTALK", "ALL", "DISCARD_DEFAULT"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert list(tm.BITS.items()) == list(jm.BITS.items())


def test_instrument_constants_copy():
    from blackbox_tpu.config import defaults as jd
    from blackbox_tpu.config.base import get_par
    from blackbox_tpu_torch import config as tc
    assert tc.GAIN == jd.GAIN
    assert tc.SATLEVEL == jd.SATLEVEL
    s = jd.ReductionSettings()
    for tel in ("ML1", "BG2", "BG3", "BG4"):
        assert tc.get_par(tc.SIGCLIP, tel) == get_par(s.sigclip, tel)
        assert (tc.get_par(tc.SUBTRACT_MBIAS, tel)
                == get_par(s.subtract_mbias, tel))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_comparator_networks_copy(k):
    from blackbox_tpu.ops import filters as jf
    from blackbox_tpu_torch.ops import filters as tf
    assert tf.transposition_pairs(k) == jf.transposition_pairs(k)
    assert tf.sorted_column_network(k) == jf.sorted_column_network(k)
    ranks = (k * k // 2,)
    assert tf.sc_select_ops(k, ranks) == jf.sc_select_ops(k, ranks)
    # the full-sort order the masked median reads
    assert tf.sc_select_ops(k, tuple(range(k * k))) == \
        jf.sc_select_ops(k, tuple(range(k * k)))


def test_fast_fft_size_copy():
    from blackbox_tpu.ops.zogy import fast_fft_size as jfast
    from blackbox_tpu.ops.zogy import split_fft_size as jsplit
    from blackbox_tpu_torch.ops import satdet, zogy
    # one copy, in ops/zogy.py, which ops/satdet.py imports
    assert satdet.fast_fft_size is zogy.fast_fft_size
    for m in (1, 7, 240, 990, 1000, 1584, 10560):
        assert zogy.fast_fft_size(m) == jfast(m)
        assert zogy.split_fft_size(m) == jsplit(m)


def test_every_port_module_is_guarded():
    """Every module of the port is in SLICE_MODULES, so the no-jax
    import test covers modules added later too."""
    import pathlib
    pkg = pathlib.Path(REPO) / "blackbox_tpu_torch"
    found = {".".join(p.relative_to(REPO).with_suffix("").parts)
             for p in pkg.rglob("*.py") if p.name != "__init__.py"}
    assert found <= set(SLICE_MODULES), sorted(found - set(SLICE_MODULES))


@pytest.mark.parametrize("N", [16, 96, 160, 352, 384, 1344, 10752])
def test_fft_plan_copy(N):
    from blackbox_tpu.pallas import fft as jfft
    from blackbox_tpu_torch.ops import fft as tfft
    assert tfft.plan(N) == jfft.plan(N)
    N1, _, k = jfft.plan(N)
    np.testing.assert_array_equal(tfft._bitrev(N1, k), jfft._bitrev(N1, k))
    for f in ("spectrum_perm", "spectrum_freqs", "mirror_perm"):
        np.testing.assert_array_equal(getattr(tfft, f)(N),
                                      getattr(jfft, f)(N))
    for inverse in (False, True):
        for a, b in zip(tfft._tables(N, inverse), jfft._tables(N, inverse)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for bad in (84, 10560):
        with pytest.raises(ValueError):
            tfft.plan(bad)


def test_warp_host_helpers_copy():
    from blackbox_tpu.ops import warp as jwarp
    from blackbox_tpu_torch.ops import warp as twarp
    rng = np.random.default_rng(0)
    gy = np.arange(0, 10560 + 32, 32, np.float64)
    gx = np.arange(0, 10560 + 32, 32, np.float64)
    gyy, gxx = np.meshgrid(gy - 5280, gx - 5280, indexing="ij")
    th = np.deg2rad(0.05)
    sx = (5280 + np.cos(th) * gxx + np.sin(th) * gyy + 3.2).astype(
        np.float32)
    sy = (5280 - np.sin(th) * gxx + np.cos(th) * gyy - 2.7
          + rng.normal(0, 0.1, gyy.shape)).astype(np.float32)
    for blocks in (1, 8):
        assert (twarp.grid_shift_ranges(sy, sx, step=32, blocks=blocks)
                == jwarp.grid_shift_ranges(sy, sx, step=32, blocks=blocks))
    assert twarp.grid_row_margin(sy, 32) == jwarp.grid_row_margin(sy, 32)


def test_science_params_carry_across():
    from blackbox_tpu.ops.transients import TransientParams as JTP
    from blackbox_tpu.ops.zogy import ZogyParams as JZP
    from blackbox_tpu_torch.ops.transients import TransientParams
    from blackbox_tpu_torch.ops.zogy import ZogyParams
    for mine, ref in ((ZogyParams, JZP), (TransientParams, JTP)):
        assert _fields(mine()) == _fields(ref()), mine.__name__
        changed = dataclasses.replace(
            ref(), **{"fft": "split", "kernel_stamp": 128}
            if ref is JZP else {"nsigma": 5.0, "label_iters": 32})
        assert _fields(mine.from_reference(changed)) == _fields(changed)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same_context(got, want):
    """Every field of the JAX context, nested dataclasses included."""
    assert set(_fields(got)) == set(_fields(want))
    for name, value in _fields(want).items():
        mine = getattr(got, name)
        if dataclasses.is_dataclass(value):
            assert _fields(mine) == _fields(value), name
        else:
            assert mine == value, name


def test_from_reference_carries_every_field():
    from torch_parity import jax_ctx
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext
    ref = jax_ctx()
    _assert_same_context(ReduceContext.from_reference(ref), ref)
    # changed nested values carry across too
    ref2 = dataclasses.replace(
        ref, os_params=dataclasses.replace(ref.os_params, mode="BG",
                                           hos_poldeg=5),
        psf_params=dataclasses.replace(ref.psf_params, size=21))
    _assert_same_context(ReduceContext.from_reference(ref2), ref2)


@pytest.mark.parametrize("tel", ["ML1", "BG2"])
@pytest.mark.parametrize("gname", ["MEERLICHT", "TINY"])
def test_from_defaults_matches_from_settings(tel, gname):
    """The port's default context equals the JAX package's
    ReduceContext.from_settings(ReductionSettings()), PSF stages on."""
    from blackbox_tpu.config.defaults import ReductionSettings
    from blackbox_tpu.core import geometry as jg
    from blackbox_tpu.pipeline.reduce import ReduceContext as JCtx
    from blackbox_tpu_torch.core import geometry as tg
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext
    want = JCtx.from_settings(ReductionSettings(geometry=getattr(jg, gname)),
                              tel)
    assert want.fit_psf
    got = ReduceContext.from_defaults(getattr(tg, gname), tel)
    _assert_same_context(got, want)
    np.testing.assert_array_equal(got.gains, want.gains)


def _c_launchers():
    """Each ``extern "C" int bbt_*(...)`` launcher in csrc/*.cu: its
    parameters as ctypes kinds (a pointer, an int or a float)."""
    import re
    from blackbox_tpu_torch import kernels
    found = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r'extern "C" int (bbt_\w+)\(([^)]*)\)',
                                       text):
            kinds = []
            for p in params.split(","):
                p = p.strip()
                kinds.append("P" if "*" in p else
                             "F" if p.startswith("float") else "I")
            found[name] = tuple(kinds)
    return found


def test_launcher_signatures_match_sources():
    """kernels._SIGNATURES binds every launcher of csrc/ with the
    parameters its C declaration has, in order: a mismatch would pass
    arguments in the wrong slots on the card, where no test here runs."""
    import ctypes
    from blackbox_tpu_torch import kernels
    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    declared = _c_launchers()
    assert set(declared) == set(kernels._SIGNATURES)
    for name, argtypes in kernels._SIGNATURES.items():
        assert tuple(kind[a] for a in argtypes) == declared[name], name
    assert sorted(kernels.LAUNCHERS.values()) == sorted(kernels._SIGNATURES)


@pytest.mark.parametrize("case", ["cpu", "two devices", "strided"])
def test_launch_rejects_operands_before_loading(case, monkeypatch):
    """kernels.launch refuses a CPU operand, operands on two devices and
    a non-contiguous operand with a ValueError, without building or
    loading the library and without counting the call."""
    import types

    import torch
    from blackbox_tpu_torch import kernels

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "_lib", no_library)

    def card(index, contiguous=True):
        # a stand-in for a CUDA tensor: launch reads only these two
        return types.SimpleNamespace(device=torch.device("cuda", index),
                                     is_contiguous=lambda: contiguous)

    operands, message = {
        "cpu": ((card(0), torch.zeros(4)), "CUDA tensors on one device"),
        "two devices": ((card(0), card(1)), "CUDA tensors on one device"),
        "strided": ((card(0), card(0, contiguous=False)), "contiguous"),
    }[case]
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match=message):
        kernels.launch("fill_holes", operands, 0, 0, 0, 1, 1, 1, 1)
    assert dict(kernels.launches) == before


def _source(pkg, dotted):
    import pathlib
    base = pathlib.Path(REPO, pkg, *dotted.split("."))
    path = base / "__init__.py" if base.is_dir() else base.with_suffix(".py")
    text = path.read_text()
    if pkg == "blackbox_tpu":
        text = text.replace("blackbox_tpu.", "blackbox_tpu_torch.")
    return text


def _without_docstrings(tree):
    """``tree`` with every docstring (module, class, function) removed:
    the copies' docstrings and comments speak of the port, their code
    is the original's."""
    import ast
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant) and isinstance(
                        first.value.value, str):
                node.body = node.body[1:] or [ast.Pass()]
    return tree


def _top_level(text, skip=()):
    """ast.dump of each top-level statement, docstrings aside, but the
    functions in ``skip`` (methods as ``Class.method``), by name."""
    import ast
    body = _without_docstrings(ast.parse(text)).body
    out, names = [], set()
    for node in body:
        name = getattr(node, "name", None)
        if isinstance(node, ast.ClassDef):
            kept = []
            for m in node.body:
                full = f"{name}.{getattr(m, 'name', None)}"
                names.add(full)
                if full not in skip:
                    kept.append(m)
            node.body = kept
        if name is not None:
            names.add(name)
        if name not in skip:
            out.append(ast.dump(node))
    return out, names


@pytest.mark.parametrize("dotted", sorted(HOST_COPIES))
def test_host_copy(dotted):
    """The port's copy of a host module is the JAX package's code, but
    for the functions named in HOST_COPIES, each of which it must
    have."""
    skip = HOST_COPIES[dotted]
    want, _ = _top_level(_source("blackbox_tpu", dotted), skip)
    got, names = _top_level(_source("blackbox_tpu_torch", dotted), skip)
    assert set(skip) <= names, sorted(set(skip) - names)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


@pytest.mark.parametrize("dotted, fn", HOST_FUNCTIONS)
def test_host_function_copy(dotted, fn):
    """A single copied host function is the JAX package's code."""
    import ast

    def body(pkg):
        found = [node for node in _without_docstrings(
                     ast.parse(_source(pkg, dotted))).body
                 if getattr(node, "name", None) == fn]
        assert len(found) == 1, (pkg, dotted, fn)
        return ast.dump(found[0])

    assert body("blackbox_tpu_torch") == body("blackbox_tpu")


@pytest.mark.parametrize("tel", ["ML1", "BG3"])
def test_from_settings_matches_jax(tel):
    """The port's ReduceContext.from_settings equals the JAX package's
    on settings away from the defaults, overrides included."""
    from blackbox_tpu.config.defaults import ReductionSettings as JS
    from blackbox_tpu.pipeline.reduce import ReduceContext as JCtx
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core import geometry as tg
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext
    kw = dict(sepmed=True, niter=2, det_nsigma=2.5, max_sources=512,
              sat_bin=4, size_vignet=21, bkg_boxsize=64,
              apphot_radii=[1.0, 2.0], correct_nonlin=True,
              subtract_mbias=True, voscan_poldeg=2)
    want = JCtx.from_settings(JS(**kw), tel, fit_psf=False)
    got = ReduceContext.from_settings(
        ReductionSettings(geometry=tg.MEERLICHT, **kw), tel, fit_psf=False)
    _assert_same_context(got, want)
