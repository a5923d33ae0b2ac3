"""The port's last host copies run: the SLURM cluster adapters
(orchestration/cluster.py, whose jobs run the port's command line), the
in-memory GCS double (io/fakegcs.py) behind the port's storage layer,
the Pub/Sub bucket-event parser (orchestration/pubsub.py) and the
device watchdog (utils/watchdog.py).  tests/test_torch_import.py holds
each to its original; these run them, against the JAX package's where
both give a value."""

import time

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (pins torch threads)


def test_sbatch_script_runs_the_port():
    from blackbox_tpu.orchestration.cluster import sbatch_script as jscript
    from blackbox_tpu_torch.orchestration.cluster import sbatch_script
    got = sbatch_script("/data/raw/f.fits", "BG2", "f", "/logs/f.out",
                        ngaia=6e5)
    want = jscript("/data/raw/f.fits", "BG2", "f", "/logs/f.out", ngaia=6e5)
    assert "-m blackbox_tpu_torch --telescope BG2" in got
    assert got == want.replace("-m blackbox_tpu ", "-m blackbox_tpu_torch ")


def test_night_chain_runs_the_port(tmp_path):
    from blackbox_tpu_torch.orchestration.cluster import (SlurmRunner,
                                                          run_night_chain)
    scripts = []

    def submit(path):
        scripts.append(open(path).read())
        return str(len(scripts))

    r = SlurmRunner(str(tmp_path), submit_fn=submit,
                    state_fn=lambda jid: "COMPLETED")
    names = run_night_chain(r, "20260301", "ML1", poll_s=0.0)
    assert names[0] == "masters_20260301" and names[-1] == "obslog_20260301"
    assert len(scripts) == len(names) == 7
    assert all("blackbox_tpu_torch" in s for s in scripts)
    assert not any("-m blackbox_tpu " in s or "from blackbox_tpu."
                   in s for s in scripts)


@pytest.fixture()
def gcs():
    from blackbox_tpu_torch.io.fakegcs import FakeGCSFileSystem
    from blackbox_tpu_torch.io.storage import set_gcs_filesystem
    fs = FakeGCSFileSystem()
    set_gcs_filesystem(fs, backoff=0.0)
    yield fs
    set_gcs_filesystem(None)


def test_fake_gcs_behind_the_storage_layer(gcs):
    from blackbox_tpu_torch.io.storage import (GCSBackend, get_backend,
                                               list_files)
    be = get_backend("gs://bucket/a.txt")
    assert isinstance(be, GCSBackend)
    be.write_bytes("gs://bucket/red/2024/a.txt", b"hello")
    be.write_bytes("gs://bucket/red/2024/b.txt", b"world!")
    assert be.read_bytes("gs://bucket/red/2024/a.txt") == b"hello"
    assert list_files("gs://bucket/red/2024/") == [
        "gs://bucket/red/2024/a.txt", "gs://bucket/red/2024/b.txt"]
    be.remove("gs://bucket/red")
    assert not be.isdir("gs://bucket/red")


def test_rice_product_over_fake_gcs(gcs):
    from blackbox_tpu_torch.io.fits import Header
    from blackbox_tpu_torch.io.rice import read_rice, write_rice
    img = np.random.default_rng(0).normal(100, 3, (64, 80)).astype(
        np.float32)
    h = Header()
    h["FILTER"] = ("q", "")
    write_rice("gs://bucket/red/x_red.fits.fz", img, h, qlevel=16)
    back, hb = read_rice("gs://bucket/red/x_red.fits.fz")
    assert back.shape == img.shape and hb["FILTER"] == "q"
    assert float(np.abs(back - img).max()) < 1.0


@pytest.mark.parametrize("data, attrs", [
    (b'{"bucket": "b", "name": "raw/x.fits.fz"}', None),
    (b"", {"bucketId": "b", "objectId": "raw/x.fits.fz"}),
    (b"", {"bucketId": "b", "objectId": "raw/x.fits.fz",
           "eventType": "OBJECT_DELETE"}),
    (b'{"bucket": "b", "name": "raw/x.txt"}', None),
    (b"not json", None)])
def test_pubsub_event_parsing(data, attrs):
    from blackbox_tpu.orchestration.pubsub import parse_bucket_event as jp
    from blackbox_tpu_torch.orchestration.pubsub import parse_bucket_event
    assert parse_bucket_event(data, attrs) == jp(data, attrs)


def test_watchdog_pass_and_hang():
    from blackbox_tpu_torch.utils.watchdog import (DeviceHang,
                                                   run_with_watchdog)
    assert run_with_watchdog(lambda a: a + 1, 41, timeout_s=5) == 42
    t0 = time.time()
    with pytest.raises(DeviceHang, match="sleepy"):
        run_with_watchdog(time.sleep, 2.0, timeout_s=0.2, label="sleepy")
    assert time.time() - t0 < 1.5
