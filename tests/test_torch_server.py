"""The port's HTTP serving gateway against the JAX package's engine, on
the CPU: the cases of tests/test_serving_server.py, with every stream
held against the JAX engine's stream for the same seeded request.

``llama_tiny`` weights come from the JAX model (``load_decode_params``);
the JAX side runs its plain decode attention, the port its default, whose
kernel wrappers take their plain versions on CPU tensors. Every server
here binds port 0, every HTTP call carries a timeout, and every gateway
shuts down in a finalizer, so no driver thread outlives the test.
"""
import http.client
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving.decode import llama_decode_params
from paddle_tpu.serving.server import ServingGateway as JGateway
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving.server import (QueueFullError, ServingGateway,
                                             ServingHTTPServer, serve,
                                             serve_fleet)

from test_metrics_prom import parse_prometheus

NUM_SLOTS, S_MAX, MAX_QUEUE = 2, 128, 4


@pytest.fixture(scope="module")
def models():
    paddle.seed(21)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


@pytest.fixture(scope="module")
def server(models):
    srv = serve(models[1], port=0, num_slots=NUM_SLOTS, max_seq_len=S_MAX,
                max_queue=MAX_QUEUE, model_name="llama-tiny-test")
    try:
        a = srv.gateway.submit(GenerationRequest(prompt=_prompt(0),
                                                 max_new_tokens=2))
        a.result()
        yield srv
    finally:
        srv.shutdown(drain=False, timeout=30)


def _prompt(seed, n=8):
    return np.random.RandomState(seed).randint(0, 256, (n,)).tolist()


def _jax(models, **kw):
    """The oracle: the same request through the JAX engine."""
    jm = models[0]
    eng = JEngine(jm, num_slots=NUM_SLOTS, max_seq_len=S_MAX,
                  decode_chunk=1,
                  jit_cache=jm.__dict__.setdefault("_serving_jit", {}))
    out = eng.generate([JRequest(**kw)])[0]
    return out.tolist(), out.finish_reason


def _post(srv, payload, timeout=120):
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        srv.url + "/v1/completions", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), dict(e.headers)


def _sse(srv, payload, timeout=120):
    """POST with stream=true; return (tokens, finish_reason, usage)."""
    body = json.dumps(dict(payload, stream=True)).encode()
    req = urllib.request.Request(srv.url + "/v1/completions", data=body)
    toks, reason, usage = [], None, None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            ch = json.loads(data)["choices"][0]
            if ch["finish_reason"] is not None:
                reason, usage = ch["finish_reason"], json.loads(data).get(
                    "usage")
            elif ch["token_id"] is not None:
                toks.append(ch["token_id"])
    return toks, reason, usage


def _get(srv, path, timeout=30):
    with urllib.request.urlopen(srv.url + path, timeout=timeout) as r:
        return r.read().decode(), dict(r.headers)


def _wait(pred, timeout=10):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


class TestCompletions:
    def test_blocking_matches_jax_engine(self, models, server):
        want, want_reason = _jax(models, prompt=_prompt(2), max_new_tokens=6)
        status, doc, _ = _post(server, {"prompt": _prompt(2),
                                        "max_tokens": 6})
        assert status == 200 and doc["object"] == "text_completion"
        choice = doc["choices"][0]
        assert choice["token_ids"] == want
        assert choice["finish_reason"] == want_reason == "length"
        assert doc["usage"] == {"prompt_tokens": 8, "completion_tokens": 6,
                                "total_tokens": 14}

    def test_sse_stream_matches_jax_engine_sampled(self, models, server):
        want, _ = _jax(models, prompt=_prompt(3), max_new_tokens=7,
                       temperature=0.9, top_k=5, seed=123)
        toks, reason, usage = _sse(server, {
            "prompt": _prompt(3), "max_tokens": 7, "temperature": 0.9,
            "top_k": 5, "seed": 123})
        assert toks == want
        assert reason == "length" and usage["completion_tokens"] == 7

    def test_long_prompt_chunks_and_matches(self, models):
        """A prompt past prefill_chunk rides the unified step in chunks."""
        srv = serve(models[1], port=0, num_slots=NUM_SLOTS,
                    max_seq_len=S_MAX, prefill_chunk=16,
                    prefix_block_size=8, headroom_mult=None)
        try:
            jm = models[0]
            want = JEngine(jm, num_slots=NUM_SLOTS, max_seq_len=S_MAX,
                           decode_chunk=1, prefill_chunk=16,
                           prefix_block_size=8, headroom_mult=None).generate(
                [JRequest(prompt=_prompt(9, 50), max_new_tokens=5)])[0]
            toks, reason, _ = _sse(srv, {"prompt": _prompt(9, 50),
                                         "max_tokens": 5})
            assert toks == want.tolist() and reason == "length"
            assert srv.gateway.engine.stats["prefill_chunks"] > 1
        finally:
            srv.shutdown(drain=False, timeout=30)

    def test_eos_maps_to_stop(self, models, server):
        free, _ = _jax(models, prompt=_prompt(4), max_new_tokens=12)
        eos = free[2]
        status, doc, _ = _post(server, {
            "prompt": _prompt(4), "max_tokens": 12, "eos_token_id": eos})
        assert status == 200
        choice = doc["choices"][0]
        assert choice["finish_reason"] == "stop"
        assert choice["token_ids"] == free[:free.index(eos) + 1]

    def test_validation_400(self, server):
        for bad in ({"max_tokens": 4},                       # no prompt
                    {"prompt": "text"},                      # not ids
                    {"prompt": [1, 2], "max_tokens": 0},
                    {"prompt": [1] * 200, "max_tokens": 8},  # > cache
                    {"prompt": [1, 2], "priority_class": "gold"}):
            status, doc, _ = _post(server, bad)
            assert status == 400, bad
            assert doc["error"]["type"] == "invalid_request"

    def test_unknown_routes_404(self, server):
        status, _, _ = _post(server, {})
        assert status in (400, 404)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server.url + "/nope", timeout=10)
        assert e.value.code == 404

    def test_healthz(self, server):
        doc = json.loads(_get(server, "/healthz")[0])
        assert doc["status"] == "ok"
        assert doc["num_slots"] == NUM_SLOTS
        assert doc["engine_restarts"] == 0

    def test_debug_requests_shows_live_rows(self, server):
        gw = server.gateway
        s = gw.submit(GenerationRequest(prompt=_prompt(12),
                                        max_new_tokens=60))
        next(iter(s))
        rows = json.loads(_get(server, "/debug/requests")[0])["requests"]
        s.cancel()
        s.result()
        row, = [r for r in rows if r["id"] == s.id]
        assert row["prompt_tokens"] == 8 and row["class"] == "standard"
        assert row["launches"] >= 1 and row["kv_bytes"] > 0


class TestCancellation:
    def test_cancel_mid_stream_frees_slot(self, models, server):
        gw = server.gateway
        eng = gw.engine
        free0 = eng.cache.num_free
        want, _ = _jax(models, prompt=_prompt(5), max_new_tokens=40)
        bystander = gw.submit(GenerationRequest(prompt=_prompt(5),
                                                max_new_tokens=40))
        victim = gw.submit(GenerationRequest(prompt=_prompt(6),
                                             max_new_tokens=100))
        it = iter(victim)
        got = [next(it) for _ in range(3)]
        victim.cancel()
        tail = list(it)
        assert victim.finish_reason == "cancelled"
        assert len(got) == 3 and len(got) + len(tail) < 100
        ids, reason = bystander.result()
        assert ids.tolist() == want and reason == "length"
        assert _wait(lambda: eng.cache.num_free == free0)

    def test_http_client_disconnect_cancels(self, server):
        eng = server.gateway.engine
        free0 = eng.cache.num_free
        cancelled0 = eng.stats["cancelled"]
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=30)
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": _prompt(7), "max_tokens": 110, "stream": True}))
        resp = conn.getresponse()
        assert resp.status == 200
        resp.fp.readline(), resp.fp.readline()
        resp.close()
        conn.close()
        assert _wait(lambda: eng.stats["cancelled"] == cancelled0 + 1)
        assert _wait(lambda: eng.cache.num_free == free0)


class TestDeadlines:
    def test_running_timeout_over_http(self, server):
        eng = server.gateway.engine
        free0 = eng.cache.num_free
        # 0.2 s: room for the first token on a loaded CPU, well short of
        # 119 tokens (about 6 ms a step here unloaded)
        status, doc, _ = _post(server, {
            "prompt": _prompt(8), "max_tokens": 119, "timeout_s": 0.2})
        assert status == 200
        choice = doc["choices"][0]
        assert choice["finish_reason"] == "timeout"
        assert 0 < len(choice["token_ids"]) < 119
        assert _wait(lambda: eng.cache.num_free == free0)

    def test_queued_timeout_never_claims_slot(self, server):
        gw = server.gateway
        eng = gw.engine
        hogs = [gw.submit(GenerationRequest(prompt=_prompt(9 + i),
                                            max_new_tokens=60))
                for i in range(NUM_SLOTS)]
        assert _wait(lambda: gw.queue_depth == 0)
        prefills0 = eng.stats["prefills"]
        doomed = gw.submit(GenerationRequest(
            prompt=_prompt(11), max_new_tokens=50, timeout_s=0.01))
        ids, reason = doomed.result()
        assert reason == "timeout" and len(ids) == 0
        for h in hogs:
            assert h.result()[1] == "length"
        assert eng.stats["prefills"] == prefills0


class TestAdmissionControl:
    def test_429_when_waiting_room_full(self, server):
        gw = server.gateway
        hogs = [gw.submit(GenerationRequest(prompt=_prompt(20 + i),
                                            max_new_tokens=100))
                for i in range(NUM_SLOTS)]
        assert _wait(lambda: gw.queue_depth == 0)
        queued = [gw.submit(GenerationRequest(prompt=_prompt(30 + i),
                                              max_new_tokens=4))
                  for i in range(MAX_QUEUE)]
        with pytest.raises(QueueFullError):
            gw.submit(GenerationRequest(prompt=_prompt(40),
                                        max_new_tokens=4))
        status, doc, headers = _post(server, {"prompt": _prompt(41),
                                              "max_tokens": 4})
        assert status == 429
        assert doc["error"]["type"] == "rate_limit"
        assert headers.get("Retry-After") == "1"
        for s in hogs + queued:
            s.result()


def _families(text):
    return {name: fam.get("type") for name, fam in
            parse_prometheus(text).items()}


class TestMetricsEndpoint:
    def test_scrape_parses_with_the_jax_gateways_series(self, models,
                                                         server):
        _post(server, {"prompt": _prompt(50), "max_tokens": 3})
        text, headers = _get(server, "/metrics")
        assert headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        fams = parse_prometheus(text)      # strict: raises on format
        assert fams["serving_num_slots"]["samples"][
            ("serving_num_slots", ())] == NUM_SLOTS
        assert fams["serving_generated_tokens_total"]["samples"][
            ("serving_generated_tokens_total", ())] > 0
        assert fams["serving_decode_compilations"]["samples"][
            ("serving_decode_compilations", ())] == 1
        assert fams["serving_ttft_seconds"]["samples"][
            ("serving_ttft_seconds_count", ())] > 0
        fin = fams["serving_finished_total"]["samples"]
        assert any(lab == (("reason", "length"),) for (_, lab) in fin)
        # the JAX gateway over the same engine knobs, after one request
        jm = models[0]
        jgw = JGateway(JEngine(jm, num_slots=NUM_SLOTS, max_seq_len=S_MAX,
                               decode_chunk=1,
                               jit_cache=jm.__dict__.setdefault(
                                   "_serving_jit", {})),
                       max_queue=MAX_QUEUE)
        try:
            jgw.submit(JRequest(prompt=_prompt(50), max_new_tokens=3)
                       ).result()
            ref = jgw.registry.render()
        finally:
            jgw.shutdown(drain=False, timeout=30)
        assert _families(text) == _families(ref)


class TestGracefulDrain:
    def test_drain_finishes_inflight_then_503(self, models):
        srv = serve(models[1], port=0, num_slots=NUM_SLOTS,
                    max_seq_len=S_MAX, max_queue=8, model_name="drain")
        try:
            gw = srv.gateway
            streams = [gw.submit(GenerationRequest(prompt=_prompt(60 + i),
                                                   max_new_tokens=10 + i))
                       for i in range(4)]
            url = srv.url
        finally:
            srv.shutdown(drain=True, timeout=60)
        assert [s.finish_reason for s in streams] == ["length"] * 4
        ids, _ = streams[2].result()
        assert len(ids) == 12
        with pytest.raises(Exception):
            gw.submit(GenerationRequest(prompt=_prompt(70),
                                        max_new_tokens=2))
        with pytest.raises(OSError):
            urllib.request.urlopen(url + "/healthz", timeout=5)

    def test_shutdown_without_drain_cancels(self, models):
        srv = serve(models[1], port=0, num_slots=1, max_seq_len=S_MAX,
                    max_queue=8, model_name="cancel")
        try:
            gw = srv.gateway
            streams = [gw.submit(GenerationRequest(prompt=_prompt(80 + i),
                                                   max_new_tokens=110))
                       for i in range(3)]
        finally:
            srv.shutdown(drain=False, timeout=30)
        assert all(s.finish_reason in ("cancelled", "length")
                   for s in streams)
        assert any(s.finish_reason == "cancelled" for s in streams)
        assert not gw._thread.is_alive()


class TestCompileOnce:
    def test_mixed_http_traffic_keeps_one_decode_program(self, models):
        """Varied sampling knobs, prompt lengths, a cancellation and a
        timeout over HTTP leave ``decode_compilations() == 1``, and the
        prefill count equals the JAX engine's for the same requests."""
        eng = ContinuousBatchingEngine(
            models[1], num_slots=NUM_SLOTS, max_seq_len=S_MAX,
            decode_chunk=1, jit_cache={})
        gw = ServingGateway(eng, max_queue=8)
        srv = ServingHTTPServer(gw, port=0).start()
        try:
            _post(srv, {"prompt": _prompt(90), "max_tokens": 5})
            assert eng.decode_compilations() == 1
            _post(srv, {"prompt": _prompt(91), "max_tokens": 9,
                        "temperature": 1.1, "top_k": 7, "seed": 4})
            _post(srv, {"prompt": _prompt(92, n=13), "max_tokens": 3,
                        "temperature": 0.4, "seed": 9})
            toks, reason, _ = _sse(srv, {"prompt": _prompt(93, n=5),
                                         "max_tokens": 6, "seed": 1,
                                         "temperature": 0.7, "top_k": 3})
            assert len(toks) == 6 and reason == "length"
            victim = gw.submit(GenerationRequest(prompt=_prompt(94),
                                                 max_new_tokens=100))
            next(iter(victim))
            victim.cancel()
            _, t_reason = gw.submit(GenerationRequest(
                prompt=_prompt(95), max_new_tokens=119,
                timeout_s=0.05)).result()
            assert t_reason == "timeout"
            assert eng.decode_compilations() == 1
        finally:
            srv.shutdown(drain=False, timeout=30)
        jeng = JEngine(models[0], num_slots=NUM_SLOTS, max_seq_len=S_MAX,
                       decode_chunk=1, jit_cache={})
        for s, n in ((90, 8), (91, 8), (92, 13), (93, 5), (94, 8), (95, 8)):
            jeng.generate([JRequest(prompt=_prompt(s, n=n),
                                    max_new_tokens=2)])
        assert eng.prefill_compilations() == jeng.prefill_compilations()
        assert jeng.decode_compilations() == 1


def test_serve_fleet_names_its_step(models):
    with pytest.raises(NotImplementedError, match="Queue A step 9"):
        serve_fleet(models[1], port=0)


def _start_cli(module, env=None):
    import os
    import subprocess
    import sys
    cmd = [sys.executable, "-m", module, "--preset", "tiny", "--port", "0",
           "--quiet"]
    if module.startswith("paddle_tpu_torch"):
        cmd += ["--device", "cpu"]
    return subprocess.Popen(cmd, cwd=str(__import__("pathlib").Path(
        __file__).resolve().parents[1]), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, **(env or {})))


def test_cli_banner_serves_and_drains_on_sigterm():
    """``python -m paddle_tpu_torch.serving.server --device cpu``: the
    banner equals the JAX CLI's (but for the address), one completion is
    served, and SIGTERM drains with exit 0."""
    import signal
    procs = [_start_cli("paddle_tpu_torch.serving.server"),
             _start_cli("paddle_tpu.serving.server",
                        env={"JAX_PLATFORMS": "cpu"})]
    try:
        banners = [json.loads(p.stdout.readline()) for p in procs]
        body = json.dumps({"prompt": [1, 2, 3], "max_tokens": 4}).encode()
        req = urllib.request.Request(banners[0]["listening"]
                                     + "/v1/completions", data=body)
        with urllib.request.urlopen(req, timeout=60) as r:
            doc = json.load(r)
        assert len(doc["choices"][0]["token_ids"]) == 4
        assert doc["model"] == "llama-tiny"
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert rcs[0] == 0
    for b in banners:
        b.pop("listening")
    assert banners[0] == banners[1]
    assert "# draining" in procs[0].stderr.read()
