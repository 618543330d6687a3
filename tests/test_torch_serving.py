"""Port parity of the serving layer (acestep_tpu_torch.serving: api_server,
openrouter_server, launch) against the JAX package, on the CPU.

  * ``RequestParser`` reads a table of aliased payloads exactly as the JAX one.
  * ``make_generate_fn`` and ``make_full_generate_fn`` hand their engine (or
    ``generate_music``) the same request fields as the JAX ones, uploads
    included: a recording fake engine in each package takes the calls, and
    both return the same payload bytes for the same PCM.
  * A real ``ApiServer`` on a tiny port engine (port 0, polled until each job
    ends): the job lifecycle, a failing job, auth, ``/v1/jobs`` with delete
    and requeue, ``/v1/lyrics``, ``/v1/lora``, 501 on the training and
    dataset routes, and ``/studio`` byte-equal to the JAX page.
  * ``parse_chat_messages`` on a table, and one plain and one streamed chat
    completion through ``OpenRouterServer``.
"""

import base64
import dataclasses
import json
import pathlib
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from acestep_tpu import inference as jinference
from acestep_tpu.serving import api_server as japi
from acestep_tpu.serving import launch as jlaunch
from acestep_tpu.serving import openrouter_server as jor
from acestep_tpu.utils import audio as jaudio
from acestep_tpu.utils import flac as jflac
from acestep_tpu_torch import inference as tinference
from acestep_tpu_torch import loader as tloader
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch.lora_runtime import LoRARuntime
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.models.stacking import unstack_layer_params
from acestep_tpu_torch.serving import api_server as tapi
from acestep_tpu_torch.serving import launch as tlaunch
from acestep_tpu_torch.serving import openrouter_server as tor
from acestep_tpu_torch.utils import mp3 as tmp3
from tests.test_pipeline import TINY_DIT, TINY_TEXT, TINY_VAE
from tests.test_torch_models import port_cfg

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 48000

PAYLOADS = [
    {},
    {"prompt": "soft piano", "lyric": "la la", "audioDuration": "12.5", "seeds": "7",
     "inferenceSteps": 4, "guidanceScale": "3", "batchSize": 2, "format": "FLAC"},
    {"caption": "x", "prompt": "y", "duration": None, "audio_duration": 20, "think": "yes",
     "constrained": "0", "lmTemperature": "bad", "use_random_seed": True},
    {"param_obj": json.dumps({"keyScale": "C major", "timeSignature": "4/4", "bpm": "96.7"}),
     "metas": {"vocal_language": "en", "bpm": 80}, "task": "repaint"},
    {"metadata": '{"key": "A minor", "targetDuration": 30}', "param_obj": "not json",
     "taskType": "cover", "audioCoverStrength": "0.25", "lm_cfg_scale": 2, "lmTopK": "5.9"},
    {"userMetadata": {"modelName": "m", "desc": "a query"}, "sampleQuery": "q", "on": "1",
     "use_adg": "on", "return_lrc": "true", "shift": "2.5", "inferMethod": "sde"},
]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_request_parser_matches_jax(i):
    assert tapi.PARAM_ALIASES == japi.PARAM_ALIASES
    payload = PAYLOADS[i]
    t, j = tapi.RequestParser(payload), japi.RequestParser(payload)
    for name in list(japi.PARAM_ALIASES) + ["shift", "use_adg", "return_lrc", "missing"]:
        assert t.get(name) == j.get(name), name
        assert t.str(name) == j.str(name) and t.str(name, "d") == j.str(name, "d"), name
        assert t.int(name) == j.int(name) and t.int(name, -1) == j.int(name, -1), name
        assert t.float(name) == j.float(name), name
        assert t.bool(name) == j.bool(name) and t.bool(name, True) == j.bool(name, True), name


# ---------------------------------------------------------------------------
# payload -> request, with recording fakes
# ---------------------------------------------------------------------------

class _VaeCfg:
    hop_length = 1920
    sampling_rate = SR


class _Result:
    """What the payload functions read of a GenerationResult."""

    def __init__(self, batch):
        rng = np.random.default_rng(0)
        self.pcm = [rng.integers(-30000, 30000, (batch, 4000, 2)).astype(np.int16),
                    rng.integers(-30000, 30000, (batch, 3000, 2)).astype(np.int16)]
        self.sample_rate = SR
        self.time_costs = {"total_time_cost": 0.1234567}
        self.seeds = [1]
        self.latents = np.zeros((batch, 10, 64), np.float32)

    def pcm16_segments(self):
        return self.pcm


class RecordingEngine:
    """Records what a payload function asks of the engine."""

    vae_cfg = _VaeCfg()

    def __init__(self):
        self.calls = []

    def encode_src_audio(self, audio):
        self.calls.append(("src", np.asarray(audio)))
        return np.full((1, 7, 64), float(np.asarray(audio).sum()), np.float32)

    def encode_refer_audio(self, audios):
        self.calls.append(("refer", [np.asarray(a) for a in audios]))
        return np.full((1, 1, 5, 64), 0.5, np.float32)

    def generate(self, req):
        self.calls.append(("generate", req))
        return _Result(req.batch_size)

    def get_lyric_timestamps(self, latents, req, lyric_lines=None, line_token_counts=None):
        self.calls.append(("stamps", (list(lyric_lines), list(line_token_counts))))
        return np.arange(len(line_token_counts), dtype=np.float64) * 1.5, "[00:00.00]x"

    def get_lyric_score(self, latents, req):
        return 1.25


class MiniTok:
    def encode(self, text):
        return [b % 250 for b in text.encode()][:64]


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _uploads():
    rng = np.random.default_rng(3)
    src = (rng.standard_normal((SR // 2, 2)) * 0.2).astype(np.float32)
    ref = (rng.standard_normal((SR // 4, 1)) * 0.2).astype(np.float32)
    out = {"wav": _b64(jaudio.wav_bytes(src, SR)), "flac": _b64(jflac.encode_flac(src, SR)),
           "ref_wav": "data:audio/wav;base64," + _b64(jaudio.wav_bytes(ref, SR))}
    if tmp3.encoder_available() and tmp3.decoder_available():
        out["mp3"] = _b64(tmp3.encode_mp3(src, SR))
    return out


UPLOADS = _uploads()

GEN_PAYLOADS = [
    {"prompt": "soft piano", "lyrics": "line one\nline two\n\nline three", "audioDuration": "10",
     "audio_format": "flac", "return_lrc": True, "seed": 3, "shift": 2.0},
    {"caption": "x", "duration": 60, "seed": 5, "task_type": "repaint",
     "src_audio_base64": UPLOADS["wav"], "repaint_start": 2.0, "repaint_end": 6.0},
    {"caption": "x", "task_type": "cover", "src_audio_base64": UPLOADS["flac"],
     "refer_audio_base64": UPLOADS["ref_wav"], "audio_cover_strength": 0.5,
     "format": "mp3", "track_name": "bass"},
    {"caption": "y", "lyrics": "", "guidance_scale": 3.0, "inference_steps": 4, "use_adg": 1,
     "batch_size": 2, "infer_method": "sde", "audio_format": "wav"},
] + ([{"caption": "z", "task_type": "lego", "source_audio_base64": UPLOADS["mp3"],
       "src_audio_format": "mp3", "repaint_start": 1.0}] if "mp3" in UPLOADS else [])


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=what)
    else:
        assert a == b, what


def _same_fields(got, ref):
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for n in names:
        _same(getattr(got, n), getattr(ref, n), n)


@pytest.mark.parametrize("i", range(len(GEN_PAYLOADS)))
def test_make_generate_fn_builds_the_jax_request(i):
    payload = GEN_PAYLOADS[i]
    jeng, teng = RecordingEngine(), RecordingEngine()
    ref = jlaunch.make_generate_fn(jeng, tokenizer=MiniTok() if i else None)(payload)
    got = tlaunch.make_generate_fn(teng, tokenizer=MiniTok() if i else None)(payload)
    assert [c[0] for c in teng.calls] == [c[0] for c in jeng.calls]
    for (kind, g), (_, r) in zip(teng.calls, jeng.calls):
        if kind == "generate":
            _same_fields(g, r)
        else:
            _same(g, r, kind)
    assert got == ref                          # the same payload bytes and fields
    assert got["audio_format"] in ("wav", "flac", "mp3")


@pytest.mark.parametrize("i", range(len(GEN_PAYLOADS)))
def test_make_full_generate_fn_builds_the_jax_params(i, monkeypatch):
    payload = dict(GEN_PAYLOADS[i], bpm=100, thinking=False, lm_codes_temperature=0.0,
                   lm_num_candidates=2, lmBatchChunkSize=3, keyscale="C major")
    seen = {}

    def fake(pkg):
        def generate_music(engine, lm, params, config, codec_params=None):
            seen[pkg] = (params, config, codec_params)
            return type("R", (), dict(dit_result=_Result(1), sample_rate=SR,
                                      metadata={"bpm": 100}, lm_result=None,
                                      time_costs={"a": 1.0}, seeds=[1]))()
        return generate_music

    monkeypatch.setattr(jinference, "generate_music", fake("jax"))
    monkeypatch.setattr(tinference, "generate_music", fake("port"))
    lm = type("LM", (), {"tok": MiniTok()})()
    ref = jlaunch.make_full_generate_fn(RecordingEngine(), lm, codec_params="c")(payload)
    got = tlaunch.make_full_generate_fn(RecordingEngine(), lm, codec_params="c")(payload)
    for g, r in zip(seen["port"][:2], seen["jax"][:2]):
        _same_fields(g, r)
    assert seen["port"][2] == seen["jax"][2] == "c"
    assert got == ref


# ---------------------------------------------------------------------------
# a real server on a tiny engine
# ---------------------------------------------------------------------------

def _http(port, path, body=None, key=None, raw=False):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    if key:
        req.add_header("Authorization", f"Bearer {key}")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            out = r.read()
            return r.status, (out if raw else json.loads(out))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(port, task_id, limit_s=60.0):
    deadline = time.time() + limit_s
    while time.time() < deadline:
        _, out = _http(port, "/query_result", {"task_id": task_id})
        if out["status"] in ("completed", "failed"):
            return out
        time.sleep(0.02)
    raise AssertionError(f"job {task_id} did not end in {limit_s} s")


@pytest.fixture(scope="module")
def tiny():
    """(engine, its unstacked DiT tree) on the CPU: random bf16 weights."""
    init = RandomInit(torch.device("cpu"), 0, None)
    cfgs = port_cfg(TINY_DIT), port_cfg(TINY_VAE), port_cfg(TINY_TEXT)
    tree = init.dit(cfgs[0])               # layers stacked: unstack them, as a checkpoint holds them
    base = dict(tree, layers=unstack_layer_params(tree["layers"]))
    eng = tpipeline.AceStepEngine(base, cfgs[0], init.vae(cfgs[1]), cfgs[1],
                                  init.qwen(cfgs[2]), cfgs[2], device="cpu")
    return eng, base


def test_api_server_routes(tiny, tmp_path, monkeypatch):
    monkeypatch.setenv("ACESTEP_TPU_PROGRESS_CACHE", str(tmp_path / "eta.json"))
    monkeypatch.setenv("ACESTEP_TPU_REQUEST_LOG", str(tmp_path / "requests.jsonl"))
    engine, base = tiny
    adapter = {"layers": [{"self_attn": {"q_proj": {"kernel": {
        "a": torch.randn(64, 4, generator=torch.Generator().manual_seed(i)),
        "b": torch.full((4, 64), 0.05)}}}} for i in range(2)]}
    tloader.save_params(str(tmp_path / "adapter"), adapter)
    srv = tapi.ApiServer(tlaunch.make_generate_fn(engine, tokenizer=MiniTok()),
                         lora_runtime=LoRARuntime(engine, base), api_key="",
                         audio_dir=str(tmp_path))
    port = srv.start(port=0)
    try:
        # studio and health
        for page in ("/", "/studio"):
            code, body = _http(port, page, raw=True)
            assert code == 200 and body == (REPO / "acestep_tpu/ui/studio.html").read_bytes()
        assert _http(port, "/health") == (200, {"status": "ok"})
        # a job with lyric alignment, FLAC out
        job = {"caption": "calm", "lyrics": "one\ntwo", "duration": 10, "seed": 2,
               "return_lrc": True, "audio_format": "flac"}
        code, sub = _http(port, "/release_task", job)
        assert code == 200 and sub["status"] == "queued"
        done = _wait(port, sub["task_id"])
        assert done["status"] == "completed", done
        res = done["result"]
        audio, sr = jflac.decode_flac(base64.b64decode(res["audio_base64"]))
        direct = engine.generate(tlaunch.build_request(engine, job, MiniTok())[0])
        np.testing.assert_array_equal(np.round(audio * 32767).astype(np.int16),
                                      direct.audio_i16[0])
        assert res["lrc"].count("\n") == 1 and len(res["lyric_timestamps"]) == 7
        code, lyr = _http(port, "/v1/lyrics", {"task_id": sub["task_id"]})
        assert code == 200 and lyr["lrc"] == res["lrc"]
        # no alignment asked -> 409; unknown id -> 404
        code, plain = _http(port, "/release_task", {"caption": "x", "duration": 10})
        _wait(port, plain["task_id"])
        assert _http(port, "/v1/lyrics", {"task_id": plain["task_id"]})[0] == 409
        assert _http(port, "/v1/lyrics", {"task_id": "nope"})[0] == 404
        # a failing job: an upload that is no audio
        code, bad = _http(port, "/release_task", {"caption": "x", "task_type": "repaint",
                                                  "src_audio_base64": _b64(b"not audio")})
        failed = _wait(port, bad["task_id"])
        assert failed["status"] == "failed" and "WAV" in failed["error"]
        # jobs: newest first, delete, requeue
        code, jobs = _http(port, "/v1/jobs?limit=10")
        assert [j["task_id"] for j in jobs["jobs"]] == [bad["task_id"], plain["task_id"],
                                                         sub["task_id"]]
        code, again = _http(port, "/v1/jobs/requeue", {"task_id": sub["task_id"]})
        assert code == 200 and again["task_id"] != sub["task_id"]
        assert _wait(port, again["task_id"])["result"]["audio_base64"] == res["audio_base64"]
        assert _http(port, "/v1/jobs/delete", {"task_id": plain["task_id"]}) == \
            (200, {"deleted": True})
        assert _http(port, "/v1/jobs/delete", {"task_id": plain["task_id"]})[0] == 404
        assert _http(port, "/query_result", {"task_id": plain["task_id"]})[0] == 404
        code, stats = _http(port, "/v1/stats")
        assert stats["completed"] == 3 and stats["failed"] == 1
        assert stats["latency"]["job_wall"]["count"] == 3
        log = [json.loads(line) for line in open(tmp_path / "requests.jsonl")]
        assert [r["status"] for r in log] == ["completed", "completed", "failed", "completed"]
        # LoRA: register, activate (the audio moves), deactivate (it comes back)
        assert _http(port, "/v1/lora") == (200, {"adapters": {}})
        code, out = _http(port, "/v1/lora", {"action": "register", "name": "a",
                                              "path": str(tmp_path / "adapter"), "alpha": 4})
        assert code == 200 and out["adapters"]["a"] == {"alpha": 4.0, "scale": 1.0,
                                                       "active": False}
        assert _http(port, "/v1/lora", {"action": "activate", "name": "a"})[0] == 200
        lora_job = _wait(port, _http(port, "/release_task", job)[1]["task_id"])
        assert lora_job["result"]["audio_base64"] != res["audio_base64"]
        assert _http(port, "/v1/lora", {"action": "deactivate", "name": "a"})[0] == 200
        back = _wait(port, _http(port, "/release_task", job)[1]["task_id"])
        assert back["result"]["audio_base64"] == res["audio_base64"]
        assert _http(port, "/v1/lora", {"action": "activate", "name": "b"}) == \
            (400, {"error": "unknown adapter: b"})
        assert _http(port, "/v1/lora", {"action": "register", "name": "c"}) == \
            (400, {"error": "missing field 'path'"})
        assert _http(port, "/v1/lora", {"action": "fly"})[0] == 400
        # training and dataset routes: no manager until training is ported
        for path, body in (("/v1/training/status", None), ("/v1/dataset/status", None),
                           ("/v1/training/start", {}), ("/v1/training/stop", {}),
                           ("/v1/dataset/scan", {}), ("/v1/dataset/build", {})):
            assert _http(port, path, body)[0] == 501, path
        assert _http(port, "/create_random_sample", {"query": "q"})[0] == 501
        assert _http(port, "/v1/models")[1] == {"models": ["acestep-v15-turbo-tpu"]}
        (tmp_path / "a.wav").write_bytes(jaudio.wav_bytes(np.zeros((10, 2)), SR))
        assert _http(port, "/v1/audio?path=a.wav", raw=True)[1][:4] == b"RIFF"
        assert _http(port, "/v1/audio?path=../x.wav")[0] == 403
    finally:
        srv.stop()
    # auth: every route but /health and the studio needs the key
    locked = tapi.ApiServer(lambda p: {}, api_key="secret")
    port = locked.start(port=0)
    try:
        assert _http(port, "/health")[0] == 200
        assert _http(port, "/v1/models")[0] == 401
        assert _http(port, "/release_task", {})[0] == 401
        assert _http(port, "/v1/models", key="secret")[0] == 200
        assert _http(port, "/release_task", {}, key="wrong")[0] == 401
    finally:
        locked.stop()


CHATS = [
    [{"role": "user", "content": "dreamy synthwave\nbpm: 110\nduration: 30\n"
                                 "[verse]\nneon lights\n[chorus]\nrun away"}],
    [{"role": "user", "content": [{"type": "text", "text": "jazz piano"},
                                  {"type": "image_url", "url": "x"}]}],
    [{"role": "user", "content": "first"}, {"role": "assistant", "content": "ok"},
     {"role": "user", "content": "<prompt>lofi beat</prompt> <lyrics>[verse]\nhey</lyrics>"}],
    [{"role": "user", "content": "KEYSCALE: A minor\nbpm: fast\nlanguage: en\ngenres: pop\n"
                                 "[Intro]\nbpm: 90\nend"}],
    [{"role": "system", "content": "nothing from the user"}],
]


@pytest.mark.parametrize("i", range(len(CHATS)))
def test_parse_chat_messages_matches_jax(i):
    assert tor.parse_chat_messages(CHATS[i]) == jor.parse_chat_messages(CHATS[i])


def test_chat_completions_plain_and_streamed(tiny):
    engine, _ = tiny
    generate = tlaunch.make_generate_fn(engine, tokenizer=MiniTok())
    srv = tor.OpenRouterServer(tlaunch.openrouter_generate_fn(generate))
    port = srv.start(port=0)
    msgs = [{"role": "user", "content": "calm piano\nduration: 10\n[verse]\nhello"}]
    parsed = tor.parse_chat_messages(msgs)
    direct = generate({**parsed["metadata"], "caption": parsed["caption"],
                       "lyrics": parsed["lyrics"]})
    want = jaudio.read_wav_bytes(base64.b64decode(direct["audio_base64"]))[0]
    try:
        assert _http(port, "/v1/models")[1]["data"][0]["id"] == "acestep/v15-turbo-tpu"
        code, out = _http(port, "/v1/chat/completions", {"messages": msgs})
        assert code == 200 and out["object"] == "chat.completion"
        msg = out["choices"][0]["message"]
        assert json.loads(msg["content"]) == {"caption": "calm piano", "duration": 10}
        audio, sr = jaudio.read_wav_bytes(base64.b64decode(msg["audio"]["data"]))
        assert sr == SR
        np.testing.assert_array_equal(audio, want)
        code, raw = _http(port, "/v1/chat/completions", {"messages": msgs, "stream": True},
                          raw=True)
        events = [line[6:] for line in raw.decode().split("\n\n") if line.startswith("data: ")]
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
        audio_delta = [c["choices"][0]["delta"]["audio"] for c in chunks
                       if "audio" in c["choices"][0]["delta"]]
        assert len(audio_delta) == 1
        np.testing.assert_array_equal(
            jaudio.read_wav_bytes(base64.b64decode(audio_delta[0]["data"]))[0], want)
        assert _http(port, "/v1/nothing", {})[0] == 404
    finally:
        srv.stop()
