"""OpenAI-style HTTP front-end over :class:`ServingGateway` — the port
of ``paddle_tpu/serving/server/httpd.py``.

Stdlib only (``http.server`` on a thread-per-connection
``ThreadingHTTPServer``) — no new dependencies; the heavy lifting is
the gateway's single engine-driver thread, so handler threads only
parse JSON, block on token queues, and write bytes.

Endpoints:

- ``POST /v1/completions`` — body ``{"prompt": [token ids], ...}``.
  Blocking by default (one JSON response), per-token SSE with
  ``"stream": true`` (``data: {...}`` chunks, then ``data: [DONE]``).
  This framework ships no tokenizer, so prompts and completions are
  token-id arrays — the ``choices[].token_ids`` field stands in for
  OpenAI's ``text``.
- ``GET /healthz`` — liveness + drain state + slot/queue occupancy,
  including the saturation view (running/prefilling slot counts and
  waiting-room occupancy vs capacity) so an orchestrator can make
  scale-out decisions without parsing ``/metrics``.
- ``GET /metrics`` — Prometheus text exposition
  (``profiler.metrics.MetricsRegistry``).
- ``GET /debug/trace?steps=N`` — capture ``N`` engine steps of
  request-lifecycle/step-phase trace and return Chrome trace-event
  JSON (load in Perfetto; README "Tracing & debugging").
  ``steps=0`` snapshots the current buffer (the persistent ``--trace``
  mode's read); a concurrent capture gets 409.
- ``GET /debug/requests`` — live request table: per-request state,
  slot, token progress, queue-wait/TTFT/TPOT-so-far, KV footprint plus
  the cost columns (device launches ridden, KV bytes held).
- ``GET /debug/profile`` — the cost observatory's aggregated
  cost-attribution table (per-program dispatches, host<->device bytes,
  compile events, wall EWMA / share of wall, per-decoded-token rates;
  README "Cost attribution & /debug/profile"). ``steps=N`` bounds the
  window to the next N engine steps like ``/debug/trace``; a
  concurrent window gets 409.

Load shedding maps gateway signals onto status codes: full waiting
room → 429 (with Retry-After), draining gateway → 503, validation (and
a request for a knob the port does not serve yet) → 400. A client that disconnects mid-SSE cancels its request — the
broken-pipe write error reaches ``TokenStream.cancel()``, the engine
frees the KV slot at the next step boundary, and the remaining
streams are untouched.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ..request import GenerationRequest
from .gateway import (GatewayClosedError, QueueFullError, ServingGateway,
                      TraceBusyError)

SSE_HEADERS = (("Content-Type", "text/event-stream"),
               ("Cache-Control", "no-cache"),
               ("Connection", "close"))


def _completion_body(stream, token_ids, finish_reason, model_name,
                     prompt_tokens):
    return {
        "id": stream.id,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model_name,
        "choices": [{
            "index": 0,
            "token_ids": [int(t) for t in token_ids],
            "finish_reason": finish_reason,
        }],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": len(token_ids),
            "total_tokens": prompt_tokens + len(token_ids),
        },
    }


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "paddle-tpu-serving/1.0"

    # ------------------------------------------------------------- helpers
    @property
    def gateway(self) -> ServingGateway:
        return self.server.gateway

    @property
    def fleet(self):
        """The engine fleet when this server fronts one, else None (a
        single-engine server keeps its surface unchanged)."""
        return getattr(self.server, "fleet", None)

    def log_message(self, fmt, *args):  # route through the server hook
        if self.server.log_fn is not None:
            self.server.log_fn(fmt % args)

    def _send_json(self, code, obj, extra_headers=()):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code, message, etype, extra_headers=()):
        self._send_json(code, {"error": {"message": message,
                                         "type": etype}}, extra_headers)

    # ----------------------------------------------------------------- GET
    def do_GET(self):
        path, _, query = self.path.partition("?")
        if self.fleet is not None:
            self._do_get_fleet(path, query)
            return
        if path == "/healthz":
            gw = self.gateway
            st = gw.health_state    # ok|degraded|recovering|draining
            self._send_json(503 if st == "draining" else 200, {
                "status": st,
                "active_slots": gw.engine.num_active,
                "num_slots": gw.engine.num_slots,
                # saturation view: how the held slots split between
                # decode and chunked prefill, and how full the bounded
                # waiting room is — enough for an orchestrator to see
                # "at capacity and queueing" without scraping /metrics
                "running_slots": gw.running_slots,
                "prefilling_slots": gw.prefilling_slots,
                "queue_depth": gw.queue_depth,
                "waiting_room_occupancy": gw.queue_depth,
                "waiting_room_capacity": gw.max_queue,
                # the supervisor's watchdog, externally visible: a step
                # that never returns can only be seen from out here
                "last_step_age_s": round(gw.last_step_age(), 3),
                "engine_restarts": gw.restarts,
            })
        elif path == "/debug/trace":
            qs = parse_qs(query)
            # persistent (--trace) servers default to a SNAPSHOT: a
            # parameterless probe must never clear hours of recorded
            # history — opening a fresh window there takes an explicit
            # steps=N
            default_steps = "0" if self.gateway.trace_persistent \
                else "32"
            try:
                steps = int(qs.get("steps", [default_steps])[0])
                timeout_s = float(qs.get("timeout_s", ["30"])[0])
            except ValueError as e:
                self._error(400, f"bad query parameter: {e}",
                            "invalid_request")
                return
            try:
                doc = self.gateway.capture_trace(steps=steps,
                                                 timeout_s=timeout_s)
            except TraceBusyError as e:
                self._error(409, str(e), "conflict")
                return
            self._send_json(200, doc)
        elif path == "/debug/profile":
            qs = parse_qs(query)
            try:
                steps = int(qs.get("steps", ["0"])[0])
                timeout_s = float(qs.get("timeout_s", ["30"])[0])
            except ValueError as e:
                self._error(400, f"bad query parameter: {e}",
                            "invalid_request")
                return
            try:
                doc = self.gateway.capture_profile(steps=steps,
                                                   timeout_s=timeout_s)
            except TraceBusyError as e:
                self._error(409, str(e), "conflict")
                return
            except RuntimeError as e:   # cost observatory disabled
                self._error(404, str(e), "unavailable")
                return
            self._send_json(200, doc)
        elif path == "/debug/requests":
            gw = self.gateway
            self._send_json(200, {
                "requests": gw.request_table(),
                "num_slots": gw.engine.num_slots,
                "queue_depth": gw.queue_depth,
                "tracing": gw.tracer.enabled,
            })
        elif path == "/metrics":
            body = self.gateway.registry.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._error(404, f"no route for GET {path}", "invalid_request")

    # ----------------------------------------------------------- GET/fleet
    def _do_get_fleet(self, path, query):
        """The fleet server's GET surface (README "Engine fleet"):
        ``/healthz`` aggregates replica states, ``/metrics`` renders
        the ONE shared registry (every series ``replica``-labeled),
        ``/debug/fleet`` is the per-replica operations table,
        ``/debug/requests`` merges the replica tables with a
        ``replica`` column, ``/debug/trace`` snapshots the merged
        fleet+replica timeline (step-bounded windows are a
        single-engine feature — the N drivers share no step counter),
        ``/debug/profile`` returns per-replica cost attribution plus
        fleet totals, and ``/fleet/cacheplane`` is the distributed
        prefix-cache surface (per-replica tier occupancy/digests plus
        host-to-host transfer totals)."""
        fl = self.fleet
        if path == "/healthz":
            st = fl.health_state
            self._send_json(503 if st == "draining" else 200, {
                "status": st,
                "replicas": [{
                    "replica": r.index, "state": r.state,
                    "active_slots": r.gateway.engine.num_active,
                    "num_slots": r.gateway.engine.num_slots,
                    "queue_depth": r.gateway.queue_depth,
                    "last_step_age_s":
                        round(r.gateway.last_step_age(), 3),
                    "engine_restarts": r.gateway.restarts,
                } for r in fl.replicas],
                "routable_replicas": len(fl._routable()),
                "num_replicas": len(fl.replicas),
                "router": fl.router.name,
            })
        elif path == "/metrics":
            body = fl.registry.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/debug/fleet":
            self._send_json(200, {"replicas": fl.fleet_table(),
                                  "router": fl.router.name,
                                  "health": fl.health_state})
        elif path == "/debug/requests":
            rows = []
            for rep in fl.replicas:
                for row in rep.gateway.request_table():
                    rows.append({**row, "replica": rep.index})
            self._send_json(200, {
                "requests": rows,
                "num_replicas": len(fl.replicas),
                "queue_depth": sum(r.gateway.queue_depth
                                   for r in fl.replicas)})
        elif path == "/debug/trace":
            self._send_json(200, fl.trace_doc())
        elif path == "/debug/profile":
            self._send_json(200, fl.profile_doc())
        elif path == "/fleet/cacheplane":
            self._send_json(200, fl.cache_plane_doc())
        else:
            self._error(404, f"no route for GET {path}",
                        "invalid_request")

    # ---------------------------------------------------------------- POST
    def do_POST(self):
        path = self.path.split("?", 1)[0]
        if self.fleet is not None and path in ("/fleet/drain",
                                               "/fleet/rebalance"):
            self._do_post_fleet(path)
            return
        if path != "/v1/completions":
            self._error(404, f"no route for POST {path}", "invalid_request")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, f"invalid JSON body: {e}", "invalid_request")
            return
        try:
            request = self._build_request(payload)
            # the fleet's front door routes, and sheds sideways on a full
            # replica
            front = self.fleet if self.fleet is not None else self.gateway
            stream = front.submit(request)
        except QueueFullError as e:
            self._error(429, str(e), "rate_limit",
                        extra_headers=(("Retry-After", "1"),))
            return
        except GatewayClosedError as e:
            self._error(503, str(e), "unavailable")
            return
        except (TypeError, ValueError, NotImplementedError) as e:
            self._error(400, str(e), "invalid_request")
            return
        prompt_tokens = len(request.prompt)
        if payload.get("stream", False):
            self._stream_response(stream, prompt_tokens)
            return
        # blocking path. A client that disconnects mid-generation is only
        # detectable at write time (no socket monitoring while blocked in
        # result()), so the sequence runs to completion either way — use
        # "stream": true (or timeout_s) when abandonment must free the
        # slot early.
        try:
            ids, reason = stream.result()
        except RuntimeError as e:
            # request failed engine-side (poisoned request isolated by
            # the recovery bisection, or the driver died): a PROPER
            # terminal response, never a stranded connection — the 500
            # body carries finish_reason="error" plus whatever tokens
            # streamed before the fault
            try:
                self._send_json(500, {
                    "id": stream.id,
                    "object": "text_completion",
                    "model": self.server.model_name,
                    "error": {"message": str(e), "type": "server_error"},
                    "choices": [{
                        "index": 0,
                        "token_ids": [int(t) for t in stream.tokens()],
                        "finish_reason": "error",
                    }]})
            except OSError:
                pass
            return
        try:
            self._send_json(200, _completion_body(
                stream, ids, reason, self.server.model_name, prompt_tokens))
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True  # client gone; work already done

    def _do_post_fleet(self, path):
        """Fleet operations endpoints: ``POST /fleet/drain`` body
        ``{"replica": i}`` (add ``"undrain": true`` to return it to
        rotation) migrates a replica's live work to siblings and takes
        it out of routing; ``POST /fleet/rebalance`` (optional body
        ``{"max_moves": n}``) sheds the hottest replica's youngest
        requests to the coolest."""
        fl = self.fleet
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, f"invalid JSON body: {e}", "invalid_request")
            return
        try:
            if path == "/fleet/drain":
                idx = int(payload["replica"])
                if not 0 <= idx < len(fl.replicas):
                    raise ValueError(f"no replica {idx}")
                if payload.get("undrain"):
                    fl.undrain_replica(idx)
                    self._send_json(200, {"replica": idx,
                                          "state": "accepting"})
                    return
                moved = fl.drain_replica(idx)
                self._send_json(200, {"replica": idx,
                                      "state": "draining",
                                      "migrations_requested": moved})
            else:
                moved = fl.rebalance(
                    max_moves=int(payload.get("max_moves", 8)))
                self._send_json(200, {"migrations_requested": moved})
        except (KeyError, TypeError, ValueError) as e:
            self._error(400, str(e), "invalid_request")


    def _build_request(self, p):
        prompt = p.get("prompt")
        if not isinstance(prompt, (list, tuple)) or \
                not all(isinstance(t, int) for t in prompt):
            raise ValueError(
                "'prompt' must be a list of token ids (this server is "
                "tokenizer-free); got "
                f"{type(prompt).__name__}")
        kw = {}
        if p.get("timeout_s") is not None:
            kw["timeout_s"] = float(p["timeout_s"])
        # priority class (README "Multi-tenant SLO serving"): body field
        # wins, the X-Priority-Class header covers clients whose SDK
        # cannot add body fields (a proxy can inject the header). An
        # unknown name raises ValueError inside gateway.submit's
        # validate — the 400 path below — never a driver crash.
        pclass = p.get("priority_class")
        if pclass is None:
            pclass = self.headers.get("X-Priority-Class")
        if pclass is not None:
            kw["priority_class"] = str(pclass)
        eos = p.get("eos_token_id", p.get("stop_token_id"))
        return GenerationRequest(
            prompt=list(prompt),
            max_new_tokens=int(p.get("max_tokens", 16)),
            temperature=float(p.get("temperature", 0.0)),
            top_k=int(p.get("top_k", 0)),
            eos_token_id=None if eos is None else int(eos),
            seed=None if p.get("seed") is None else int(p["seed"]),
            **kw)

    def _stream_response(self, stream, prompt_tokens):
        self.send_response(200)
        for k, v in SSE_HEADERS:
            self.send_header(k, v)
        self.end_headers()

        def event(obj):
            data = obj if isinstance(obj, str) else json.dumps(obj)
            self.wfile.write(f"data: {data}\n\n".encode())
            self.wfile.flush()

        try:
            for token in stream:
                event({"id": stream.id, "object": "text_completion.chunk",
                       "model": self.server.model_name,
                       "choices": [{"index": 0, "token_id": int(token),
                                    "finish_reason": None}]})
            event({"id": stream.id, "object": "text_completion.chunk",
                   "model": self.server.model_name,
                   "choices": [{"index": 0, "token_id": None,
                                "finish_reason": stream.finish_reason}],
                   "usage": {"prompt_tokens": prompt_tokens,
                             "completion_tokens": len(stream.tokens()),
                             "total_tokens":
                                 prompt_tokens + len(stream.tokens())}})
            event("[DONE]")
        except (BrokenPipeError, ConnectionResetError, socket.timeout):
            # client went away mid-stream: free the KV slot, leave the
            # rest of the batch untouched
            stream.cancel()
        except RuntimeError as e:
            # engine-side failure: a FINAL terminal error event (with
            # finish_reason="error") so the client sees a proper end of
            # stream, never a silently dropped connection
            try:
                event({"id": stream.id, "object": "text_completion.chunk",
                       "model": self.server.model_name,
                       "choices": [{"index": 0, "token_id": None,
                                    "finish_reason": "error"}],
                       "error": {"message": str(e),
                                 "type": "server_error"}})
                event("[DONE]")
            except OSError:
                pass
        finally:
            self.close_connection = True


class ServingHTTPServer:
    """Owns the ThreadingHTTPServer + its accept-loop thread.

    ``port=0`` binds an ephemeral port (tests); read it back from
    ``.port``. ``shutdown(drain=True)`` closes the gateway's front door,
    waits for in-flight sequences, then stops accepting.
    """

    def __init__(self, gateway, host="127.0.0.1", port=8000,
                 model_name="paddle-tpu-llama", log_fn=None, fleet=None):
        if (gateway is None) == (fleet is None):
            raise ValueError(
                "pass exactly one of gateway (single engine) or fleet")
        self.gateway = gateway
        self.fleet = fleet
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.gateway = gateway
        self._httpd.fleet = fleet
        self._httpd.model_name = model_name
        self._httpd.log_fn = log_fn
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="http-accept", daemon=True)

    @property
    def host(self):
        return self._httpd.server_address[0]

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def start(self):
        self._thread.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Graceful stop: close the front door (new completions 503),
        drain (or cancel) in-flight work, then stop the accept loop."""
        front = self.fleet if self.fleet is not None else self.gateway
        front.shutdown(drain=drain, timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False


def serve(model, host="127.0.0.1", port=8000, num_slots=8,
          max_seq_len=None, decode_chunk=1, max_queue=64,
          model_name=None, registry=None, log_fn=None, start=True,
          prefix_cache=False, prefix_blocks=None, prefix_block_size=32,
          paged_attn=True, prefill_chunk=512, ragged_step=True,
          headroom_mult=2.0, watchdog_deadline_s=30.0, max_restarts=8,
          fault_hook=None, clock=None, spec_decode=False, spec_k=4,
          drafter=None, trace=False, trace_buffer=65536, cost=True,
          decode_ticks=1, kv_dtype=None, quantize_weights=False,
          quantize_activations=False,
          tp=1, collective_dtype="fp", host_tier_bytes=0,
          classes=None, slo_ttft_ms=None, slo_tpot_ms=None,
          fused_tick=False, collective_overlap=False):
    """Build engine → gateway → HTTP server and start listening.

    The reference's argument list, in its order. The engine is built on
    the model's device (``LlamaForCausalLM(..., device="cuda")`` is the
    default); every value off the ported path raises
    ``NotImplementedError`` naming its ROADMAP step from the engine's
    constructor, before anything listens.

    ``decode_chunk=1`` is the serving default: chunk fusion trades
    per-token latency for fewer launches, the wrong trade when tokens
    stream to a client, and it keeps the decode program set at one.
    ``prefill_chunk`` (default 512 tokens) interleaves long prompts with
    decode through the unified ragged step, its per-step grant adapted
    from the measured throughput scaled by ``headroom_mult``.

    The driver is supervised (:mod:`.gateway`): a step fault is
    classified transient/fatal/hung, and a fatal one rebuilds the engine
    through the factory below — same config, same shared program cache —
    and recovers every in-flight request by recompute.
    ``watchdog_deadline_s`` bounds a step before it is classified hung
    (``0``/``None`` disables); ``max_restarts`` bounds the rebuilds;
    ``fault_hook`` threads a :class:`~..faults.FaultPlan` through every
    engine (pass its :class:`~..faults.VirtualClock` as ``clock`` too
    when it carries ``hung`` faults). ``trace=True`` records spans from
    startup (else ``GET /debug/trace?steps=N`` opens a window);
    ``cost=True`` (default) keeps the cost observatory behind
    ``/debug/profile`` and ``serving_dispatches_total``.

    ``tp=N`` serves through ``N`` head shards on the model's device:
    ``serving_collective_bytes_total{dtype}`` counts the reductions' wire bytes, ``/debug/profile`` gains
    the ``collectives`` section, ``collective_dtype="int8"`` runs the
    EQuARX all-reduce.
    """
    from ..engine import ContinuousBatchingEngine
    from ..policy import ClassTable
    priority_classes = None if classes is None else ClassTable.parse(
        classes, slo_ttft_ms=slo_ttft_ms, slo_tpot_ms=slo_tpot_ms)

    def engine_factory():
        # one factory builds the first engine AND every recovery
        # rebuild: identical config, and the model-level jit cache is
        # shared, so a rebuilt engine re-traces nothing
        # (decode_compilations() continuity across restarts)
        return ContinuousBatchingEngine(
            model, num_slots=num_slots, max_seq_len=max_seq_len,
            decode_chunk=decode_chunk, prefix_cache=prefix_cache,
            prefix_blocks=prefix_blocks,
            prefix_block_size=prefix_block_size,
            paged_attn=paged_attn, prefill_chunk=prefill_chunk,
            ragged_step=ragged_step, headroom_mult=headroom_mult,
            spec_decode=spec_decode, spec_k=spec_k, drafter=drafter,
            decode_ticks=decode_ticks, kv_dtype=kv_dtype,
            quantize_weights=quantize_weights,
            quantize_activations=quantize_activations,
            tp=tp, collective_dtype=collective_dtype,
            host_tier_bytes=host_tier_bytes,
            priority_classes=priority_classes,
            fused_tick=fused_tick,
            collective_overlap=collective_overlap,
            jit_cache=model.__dict__.setdefault("_serving_jit", {}))

    gateway = ServingGateway(
        engine_factory(), max_queue=max_queue, registry=registry,
        engine_factory=engine_factory,
        watchdog_deadline_s=watchdog_deadline_s,
        max_restarts=max_restarts, fault_hook=fault_hook, clock=clock,
        trace=trace, trace_buffer=trace_buffer, cost=cost)
    server = ServingHTTPServer(
        gateway, host=host, port=port,
        model_name=model_name or type(model).__name__, log_fn=log_fn)
    return server.start() if start else server


def serve_fleet(model, replicas=2, router="affinity", host="127.0.0.1",
                port=8000, num_slots=8, max_seq_len=None, decode_chunk=1,
                max_queue=64, model_name=None, registry=None, log_fn=None,
                start=True, prefix_cache=True, prefix_blocks=None,
                prefix_block_size=32, paged_attn=True, prefill_chunk=512,
                ragged_step=True, headroom_mult=2.0,
                watchdog_deadline_s=30.0, max_restarts=8,
                fault_hooks=None, clock=None, spec_decode=False,
                spec_k=4, drafter=None, trace=False, trace_buffer=65536,
                cost=True, affinity_band=16, decode_ticks=1,
                kv_dtype=None, quantize_weights=False,
                quantize_activations=False, tp=1,
                collective_dtype="fp", host_tier_bytes=0,
                classes=None, slo_ttft_ms=None, slo_tpot_ms=None,
                fused_tick=False, collective_overlap=False):
    """Build an engine fleet → HTTP server and start listening (README
    "Engine fleet"): ``replicas`` supervised engines — each its own
    paged pool, prefix trie and scheduler, sharing program records per
    pool geometry — behind one routed front door. The reference's
    argument list, in its order; on a card the replicas share it
    (``serving/fleet/fleet.py``).

    ``router`` picks the admission policy: ``round-robin`` (the
    baseline), ``least-loaded`` (live KV blocks + queue depth), or
    ``affinity`` (the default: longest cached-prefix match wins within
    ``affinity_band`` load units of the least-loaded replica, so
    prefix-cache hits survive fan-out). ``num_slots`` /
    ``prefill_chunk`` / ``max_seq_len`` / ``max_queue`` /
    ``prefix_blocks`` accept a scalar or one value per replica (mixed
    pool geometries get program records of their own;
    ``decode_compilations()`` reads the reference's count per
    geometry across the whole fleet).

    On top of the single-engine surface, the handler grows
    ``GET /debug/fleet`` (the per-replica operations table),
    ``POST /fleet/drain`` and ``POST /fleet/rebalance`` (live request
    migration), ``/healthz`` aggregates replica states, and every
    ``/metrics`` series carries a ``replica`` label (monotonic across
    any single replica's rebuild). A replica that dies past its
    restart budget fails over: its live requests re-admit on siblings
    by ``restore()`` recompute and the streams continue
    byte-identically — zero requests lost (the fleet chaos matrix,
    tests/test_torch_fleet.py).

    ``host_tier_bytes=N`` (scalar or per-replica, default 0) gives
    each replica a host-RAM spill tier AND turns on the fleet cache
    plane (README "Tiered KV prefix cache"): before a routed request
    submits, any spilled prefix chain it needs moves host-to-host
    from the sibling tier that holds it (content-digest addressed),
    so prefix affinity becomes a distributed prefix cache.
    ``GET /fleet/cacheplane`` is the debug surface; ``/metrics``
    grows ``serving_fleet_tier_transfers_total`` and
    ``serving_fleet_tier_transfer_bytes_total``.

    ``classes`` / ``slo_ttft_ms`` / ``slo_tpot_ms`` configure the
    multi-tenant class table fleet-wide (same grammar as
    :func:`serve`; every replica shares ONE parsed table). The
    ``class-headroom`` router routes each request by per-replica class
    pressure — the load that COULD NOT be displaced for it — so a
    latency request never lands on a replica saturated with equal-or-
    higher-rank work while a sibling has displaceable batch load;
    ``/debug/fleet`` rows grow per-class occupancy columns.
    """
    from ..fleet import EngineFleet, PrefixAffinityRouter
    from ..policy import ClassTable
    priority_classes = None if classes is None else ClassTable.parse(
        classes, slo_ttft_ms=slo_ttft_ms, slo_tpot_ms=slo_tpot_ms)
    if router == "affinity":
        router = PrefixAffinityRouter(band=affinity_band)
    fleet = EngineFleet(
        model, replicas=replicas, router=router, num_slots=num_slots,
        max_seq_len=max_seq_len, decode_chunk=decode_chunk,
        max_queue=max_queue, prefix_cache=prefix_cache,
        prefix_blocks=prefix_blocks,
        prefix_block_size=prefix_block_size, paged_attn=paged_attn,
        prefill_chunk=prefill_chunk, ragged_step=ragged_step,
        headroom_mult=headroom_mult, spec_decode=spec_decode,
        spec_k=spec_k, drafter=drafter, decode_ticks=decode_ticks,
        kv_dtype=kv_dtype, quantize_weights=quantize_weights,
        quantize_activations=quantize_activations,
        tp=tp, collective_dtype=collective_dtype,
        host_tier_bytes=host_tier_bytes,
        priority_classes=priority_classes,
        fused_tick=fused_tick, collective_overlap=collective_overlap,
        registry=registry, clock=clock,
        watchdog_deadline_s=watchdog_deadline_s,
        max_restarts=max_restarts, fault_hooks=fault_hooks,
        trace=trace, trace_buffer=trace_buffer, cost=cost, start=True)
    server = ServingHTTPServer(
        None, host=host, port=port,
        model_name=model_name or type(model).__name__, log_fn=log_fn,
        fleet=fleet)
    return server.start() if start else server
