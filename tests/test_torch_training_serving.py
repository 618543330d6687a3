"""The REST server's training and dataset routes in the port
(serving/training_manager.py, serving/dataset_manager.py) on the CPU: a
dataset built and a LoRA job run through the port's ``ApiServer`` over HTTP
(port 0), the adapter served through ``LoRARuntime``, the routes answering 501
when nothing is attached, and ``serving.launch.main`` attaching both
managers.  The default trainer factory reads a checkpoint directory the JAX
package's ``loader.save_params`` wrote, as its own test does
(tests/test_training_manager.py)."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from acestep_tpu import loader as jloader
from acestep_tpu.models import dit as jdit
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from acestep_tpu_torch.lora_runtime import LoRARuntime
from acestep_tpu_torch.serving import api_server as tapi
from acestep_tpu_torch.serving import launch as tlaunch
from acestep_tpu_torch.serving.dataset_manager import DatasetManager
from acestep_tpu_torch.serving.training_manager import TrainingManager
from acestep_tpu_torch.utils.audio import write_wav
from tests.test_pipeline import TINY_DIT, TINY_TEXT, TINY_VAE
from tests.test_torch_models import port_cfg, to_np

SR = 48000


def _http(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _poll(port, path, limit_s=120.0):
    deadline = time.time() + limit_s
    while time.time() < deadline:
        code, st = _http(port, path)
        assert code == 200
        if st["state"] in ("completed", "failed", "stopped"):
            return st
        time.sleep(0.05)
    raise AssertionError(f"{path} did not finish: {st}")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A converted checkpoint (the JAX package's save_params + config.json), the
    port's engine on the same f32 weights, and the unstacked DiT tree."""
    base = jdit.init_params(jax.random.key(0), TINY_DIT, dtype=jax.numpy.float32)
    ckpt = tmp_path_factory.mktemp("ckpt")
    jloader.save_params(str(ckpt / "dit"), base, {"component": "dit"})
    (ckpt / "config.json").write_text(json.dumps(dataclasses.asdict(TINY_DIT)))
    init = tpipeline.RandomInit(torch.device("cpu"), 0, None, dtype=torch.float32)
    from acestep_tpu_torch import weights

    dit_tree = weights.from_jax_numpy(to_np(base))
    engine = tpipeline.AceStepEngine(dit_tree, port_cfg(TINY_DIT),
                                     init.vae(port_cfg(TINY_VAE)), port_cfg(TINY_VAE),
                                     init.qwen(port_cfg(TINY_TEXT)), port_cfg(TINY_TEXT),
                                     device="cpu")
    return ckpt, engine, dit_tree


def _songs(d):
    d.mkdir()
    rng = np.random.default_rng(4)
    for name, seconds in (("one.wav", 0.4), ("two.wav", 0.6)):
        write_wav(str(d / name), (rng.standard_normal((int(seconds * SR), 2)) * 0.1)
                  .astype(np.float32), SR)
    (d / "one.txt").write_text("bright synth pop")
    return d


def test_build_train_and_serve_over_rest(checkpoint, tmp_path):
    ckpt, engine, dit_tree = checkpoint
    srv = tapi.ApiServer(tlaunch.make_generate_fn(engine),
                         lora_runtime=LoRARuntime(engine, dit_tree),
                         training_manager=TrainingManager(device="cpu"),
                         dataset_manager=DatasetManager(engine))
    port = srv.start("127.0.0.1", 0)
    try:
        songs = _songs(tmp_path / "songs")
        code, scan = _http(port, "/v1/dataset/scan", {"directory": str(songs)})
        assert code == 200 and scan["count"] == 2
        assert _http(port, "/v1/dataset/scan", {"directory": str(songs / "no")})[0] == 400
        assert [s["filename"] for s in scan["samples"]] == ["one.wav", "two.wav"]
        assert scan["samples"][0]["caption"] == "bright synth pop"
        assert "audio_path" not in scan["samples"][0]
        code, out = _http(port, "/v1/dataset/build", {"directory": str(songs)})
        assert code == 409 and "output_dir" in out["error"]
        code, out = _http(port, "/v1/dataset/build", {
            "directory": str(songs), "output_dir": str(tmp_path / "ds"), "auto_label": False})
        assert code == 200 and out["state"] == "starting"
        st = _poll(port, "/v1/dataset/status")
        assert st["state"] == "completed" and st["done"] == 2, st
        manifest = json.loads((tmp_path / "ds" / "manifest.json").read_text())
        assert manifest["count"] == 2

        code, out = _http(port, "/v1/training/start", {
            "dataset_dir": str(tmp_path / "ds"), "checkpoint_dir": str(ckpt),
            "output_dir": str(tmp_path / "out"), "mode": "lora", "lora_rank": 2,
            "total_steps": 4, "batch_size": 1, "checkpoint_every": 2, "lr": 1e-2})
        assert code == 200 and out["state"] == "starting"
        st = _poll(port, "/v1/training/status")
        assert st["state"] == "completed", st
        assert st["step"] == 4 and np.isfinite(st["loss"]) and len(st["loss_history_tail"]) == 4
        assert (tmp_path / "out" / "ckpt_0000004").is_dir()
        path = st["export_path"]
        assert path.endswith("adapter") and (tmp_path / "out" / "adapter.safetensors").exists()

        # the adapter served: activation moves the audio, deactivation restores it
        req = {"caption": "x", "duration": 10, "seed": 3}
        def audio():
            code, job = _http(port, "/release_task", req)
            assert code == 200
            deadline = time.time() + 120
            while time.time() < deadline:
                _, res = _http(port, "/query_result", {"task_id": job["task_id"]})
                if res["status"] in ("completed", "failed"):
                    assert res["status"] == "completed", res
                    return res["result"]["audio_base64"]
                time.sleep(0.05)
            raise AssertionError("job did not finish")

        before = audio()
        assert _http(port, "/v1/lora", {"action": "register", "name": "trained",
                                        "path": path, "alpha": 16.0})[0] == 200
        assert _http(port, "/v1/lora", {"action": "activate", "name": "trained",
                                        "scale": 1.0})[0] == 200
        moved = audio()
        assert _http(port, "/v1/lora", {"action": "deactivate", "name": "trained"})[0] == 200
        assert moved != before and audio() == before

        # a second job can be stopped
        code, out = _http(port, "/v1/training/start", {
            "dataset_dir": str(tmp_path / "ds"), "checkpoint_dir": str(ckpt),
            "output_dir": str(tmp_path / "out2"), "lora_rank": 2, "total_steps": 10000,
            "checkpoint_every": 0})
        assert code == 200
        assert _http(port, "/v1/training/stop", {})[1] == {"state": "stopping"}
        st = _poll(port, "/v1/training/status")
        assert st["state"] == "stopped" and st["step"] < 10000
    finally:
        srv.stop()


def test_routes_answer_501_without_managers():
    srv = tapi.ApiServer(lambda p: {})
    port = srv.start("127.0.0.1", 0)
    try:
        for path, body in (("/v1/training/status", None), ("/v1/dataset/status", None),
                           ("/v1/training/start", {}), ("/v1/training/stop", {}),
                           ("/v1/dataset/scan", {}), ("/v1/dataset/build", {})):
            code, out = _http(port, path, body)
            assert code == 501 and "not attached" in out["error"], (path, out)
    finally:
        srv.stop()


def test_failed_job_and_one_at_a_time(tmp_path):
    def finished(mgr):
        deadline = time.time() + 60
        while mgr.status()["state"] in ("starting", "running") and time.time() < deadline:
            time.sleep(0.02)
        return mgr.status()

    mgr = TrainingManager(device="cpu")
    assert mgr.start({"dataset_dir": str(tmp_path), "checkpoint_dir": str(tmp_path / "none"),
                      "output_dir": str(tmp_path / "o")})["state"] == "starting"
    st = finished(mgr)
    assert st["state"] == "failed" and st["error"]

    release = threading.Event()

    def slow_factory(payload):
        release.wait(30)
        raise RuntimeError("stopped early")

    slow = TrainingManager(trainer_factory=slow_factory)
    slow.start({})
    assert "error" in slow.start({})
    release.set()
    assert finished(slow)["state"] == "failed"


def test_launch_attaches_both_managers(checkpoint, monkeypatch):
    _, engine, dit_tree = checkpoint
    seen = {}
    monkeypatch.setattr(tlaunch, "build_engine", lambda *a, **k: (engine, dit_tree))

    def start(self, host, port):
        seen["srv"] = self
        return 1234

    monkeypatch.setattr(tapi.ApiServer, "start", start)
    monkeypatch.setattr(tapi.ApiServer, "stop", lambda self: None)

    def interrupt(_s):
        raise KeyboardInterrupt

    monkeypatch.setattr(tlaunch.time, "sleep", interrupt)
    tlaunch.main(["api", "--device", "cpu", "--checkpoint", "unused"])
    srv = seen["srv"]
    assert isinstance(srv.training_manager, TrainingManager)
    assert isinstance(srv.dataset_manager, DatasetManager)
    assert srv.dataset_manager.engine is engine and srv.lora_runtime is not None
    assert weights.tree_leaves(dit_tree)
