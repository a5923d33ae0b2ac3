"""The kernels' least times at the shapes of PERF.md's kernel table.

    python -m pytest portbench -q
"""

import pytest
import torch

from portbench import manifest, peaks

ROOF = {r.__name__.rsplit("_", 1)[-1]: r for r in manifest.rooflines()}
H = W = 10560


def least_ms(roof, rec):
    return peaks.least_s(*roof.work(rec))[0] * 1e3


def test_every_kernel_has_a_file():
    assert sorted(ROOF) == [f"K{i}" for i in range(1, 8)]
    for roof in ROOF.values():
        assert roof.KERNELS and callable(roof.record)


def test_k1_star_field():
    # bytes-bound: int32 labels in and out; a 1 % foreground at 32 steps
    rec = {"H": H, "W": W, "steps": 32, "nfg": torch.tensor(H * W // 100)}
    assert least_ms(ROOF["K1"], rec) == pytest.approx(0.266, abs=5e-4)


def test_k2_mix():
    ms = [least_ms(ROOF["K2"], {"H": H, "W": W, "k": k})
          for k in (3, 5, 5, 7)]
    assert sum(ms) == pytest.approx(1.292, abs=1e-3)
    assert ms[3] == pytest.approx(0.493, abs=1e-3)     # operations


@pytest.mark.parametrize("N, size, want", [(20000, 32, 0.0908),
                                           (1024, 96, 0.0419)])
def test_k4(N, size, want):
    rec = ROOF["K4"].record({"images": (torch.zeros(2, 2),
                                        torch.zeros(2, 2, dtype=torch.int32)),
                             "y0": torch.zeros(N), "size": size,
                             "n_active": torch.tensor(N - N // 7)}, None)
    assert least_ms(ROOF["K4"], rec) == pytest.approx(want, abs=1e-4)


def test_k6_pass():
    rec = ROOF["K6"].record({"xr": torch.zeros(10752, 1)}, None)
    rec["L"] = 10752
    assert least_ms(ROOF["K6"], rec) == pytest.approx(0.715, abs=1e-3)


def test_records_from_calls():
    """Each record reads its call's arguments and result as the hook
    binds them, and the work grows with the data it depends on."""
    lab = torch.full((64, 64), 64 * 64 + 2, dtype=torch.int32)
    lab[:8] = 1
    k1 = ROOF["K1"].record({"lab": lab, "iters": 4}, None)
    assert int(k1["nfg"]) == 8 * 64
    assert ROOF["K1"].work(k1)[2] == 8.0 * 4 * 8 * 64
    seg = torch.zeros(64, 64, dtype=torch.int32)
    seg[:3] = 7
    k5 = ROOF["K5"].record({"image": seg.float(), "bkg_std": None,
                            "excl": torch.zeros(64, 64, dtype=torch.bool),
                            "taps": (0.25, 0.5, 0.25), "iters": 10},
                           (seg, torch.tensor(1)))
    assert ROOF["K5"].work(k5) == (9.0 * 64 * 64, 12.0 * 64 * 64,
                                   8.0 * 10 * 3 * 64)
    wy = torch.zeros(64, 3)
    wy[:, 1] = 1.0
    k3 = ROOF["K3"].record({"meshes": (torch.zeros(3, 3),), "Wy": wy,
                            "Wx": wy, "out_shape": (64, 64)}, None)
    assert ROOF["K3"].work(k3)[1] == 2.0 * (64 * 3 + 64 * 64)
    k7 = ROOF["K7"].record({"data": torch.zeros(8, 8), "niter": 2}, None)
    assert ROOF["K7"].work(k7)[0] == 640.0
