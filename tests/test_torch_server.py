"""The port's batching server (``pipeline/server.py``) and its HTTP endpoint
(``scripts/serve.py``), mirroring ``tests/test_server.py``.

The fast cases run a fake pipeline (grouping keys, bucket padding,
per-request noise, guardrails at submit, a failing batch, stop). The tiny
real pipeline (fp32, CPU) then runs behind the port's server and behind
JAX's; JAX draws its noise with ``jax.random.PRNGKey(seed)``, which torch
cannot reproduce, so the port's ``_latents_for`` is given JAX's draws here
(in the test only). Bar: the edit test's, PSNR over the [-1, 1] range of at
least 60 dB; a request batched with others against the same request alone
in the port: 1e-5 (fp32; only the batch's GEMM shapes differ).
"""

import dataclasses
import io
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from chronoedit_tpu.aux import guardrails as gr_j
from chronoedit_tpu.pipeline import server as server_j
from chronoedit_tpu_torch.aux.guardrails import (
    Blocklist, GuardrailBlocked, GuardrailRunner, Guardrails)
from chronoedit_tpu_torch.configs import chronoedit_tiny
from chronoedit_tpu_torch.pipeline.server import EditServer, ServerConfig, _GroupKey, _Request
from chronoedit_tpu_torch.scripts import serve as serve_mod
from test_torch_pipeline import pipelines, psnr  # noqa: F401 (fixture)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MIN_PSNR_DB = 60.0
BATCH_TOL = 1e-5


class FakePipeline:
    """Records batch shapes and latents; returns the batch index as video."""

    def __init__(self):
        self.config = chronoedit_tiny()
        self.guardrails = None
        self.device = torch.device("cpu")
        self.batch_sizes, self.latents_seen, self.calls = [], [], []
        self.fail_next = False

    def __call__(self, image, prompt_emb, neg_prompt_emb=None, image_emb=None,
                 latents=None, **kw):
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("transient device error")
        b, _, h, w = image.shape
        self.batch_sizes.append(b)
        self.latents_seen.append(latents.clone())
        self.calls.append(kw)
        out = torch.zeros((b, 3, self.config.num_frames, h, w))
        return out + torch.arange(b, dtype=torch.float32)[:, None, None, None, None]


def _req(cfg, h=8, w=8):
    return np.zeros((1, 3, h, w), np.float32), np.zeros((1, 6, cfg.dit.text_dim), np.float32)


def _blocking(pipe):
    pipe.guardrails = Guardrails(text=GuardrailRunner(
        [("blocklist", Blocklist(exact_words=("forbidden",)))]))


def test_single_request_roundtrip():
    pipe = FakePipeline()
    srv = EditServer(pipe, ServerConfig(max_batch=4, max_wait_ms=5)).start()
    try:
        out = srv.submit(*_req(pipe.config), seed=3).result(timeout=30)
        assert isinstance(out, torch.Tensor) and out.shape == (3, 8, 8)
        assert srv.stats["batches"] == 1
        assert pipe.calls[0]["skip_text_guardrail"] is True
        assert srv.health()["device"] == "cpu"
    finally:
        srv.stop()


def test_concurrent_requests_batch_together_with_padding():
    pipe = FakePipeline()
    srv = EditServer(pipe, ServerConfig(max_batch=4, max_wait_ms=200))
    image, prompt = _req(pipe.config)
    futs = [srv.submit(image, prompt, seed=i) for i in range(3)]  # before the batcher
    srv.start()
    try:
        outs = [f.result(timeout=30) for f in futs]
        assert pipe.batch_sizes == [4]
        assert srv.stats["padded_slots"] == 1 and srv.stats["batched_requests"] == 3
        for i, o in enumerate(outs):  # de-padded, order kept
            assert torch.equal(o, torch.full_like(o, float(i)))
        lat = pipe.latents_seen[0]
        assert not torch.equal(lat[0], lat[1])
        assert torch.equal(lat[2], lat[3])  # the pad repeats the last request
        # each request's noise is its own seed's, whatever the batch
        for i in range(3):
            assert torch.equal(lat[i:i + 1], srv._latents_for(_queued(i)))
    finally:
        srv.stop()


def _queued(seed, hw=8):
    """A request of an hw x hw edit with ``seed``, as the batcher holds it
    (only its key and seed are read by ``_latents_for``)."""
    key = _GroupKey(hw, hw, None, None, None, False, 0, -1, -1, 6, True)
    return _Request(None, None, None, None, seed, key, None, 0.0)


def test_mixed_geometries_and_neg_lengths_run_apart():
    pipe = FakePipeline()
    srv = EditServer(pipe, ServerConfig(max_batch=4, max_wait_ms=100))
    i8, p = _req(pipe.config, 8, 8)
    i16, _ = _req(pipe.config, 16, 16)
    neg_a = np.zeros((1, 6, pipe.config.dit.text_dim), np.float32)
    neg_b = np.zeros((1, 12, pipe.config.dit.text_dim), np.float32)
    futs = [srv.submit(i8, p), srv.submit(i16, p), srv.submit(i8, p, neg_prompt_emb=neg_a),
            srv.submit(i8, p, neg_prompt_emb=neg_b)]
    srv.start()
    try:
        assert [f.result(timeout=30).shape[-1] for f in futs] == [8, 16, 8, 8]
        assert sorted(pipe.batch_sizes) == [1, 1, 1, 1] and srv.stats["batches"] == 4
    finally:
        srv.stop()


def test_queue_full_rejects_cleanly():
    pipe = FakePipeline()
    srv = EditServer(pipe, ServerConfig(max_queue=2))  # batcher not started
    image, prompt = _req(pipe.config)
    srv.submit(image, prompt)
    srv.submit(image, prompt)
    with pytest.raises(RuntimeError, match="queue full"):
        srv.submit(image, prompt).result(timeout=5)
    assert srv.stats["rejected"] == 1


def test_guardrail_blocks_at_submit_not_in_batch():
    pipe = FakePipeline()
    _blocking(pipe)
    srv = EditServer(pipe, ServerConfig(max_wait_ms=5)).start()
    try:
        image, prompt = _req(pipe.config)
        bad = srv.submit(image, prompt, prompt="very forbidden edit")
        ok = srv.submit(image, prompt, prompt="a nice edit")
        with pytest.raises(GuardrailBlocked):
            bad.result(timeout=10)
        assert ok.result(timeout=30).shape == (3, 8, 8)
        assert srv.stats["rejected"] == 1 and pipe.batch_sizes == [1]
    finally:
        srv.stop()


def test_pipeline_error_fails_batch_not_server():
    pipe = FakePipeline()
    pipe.fail_next = True
    srv = EditServer(pipe, ServerConfig(max_wait_ms=5)).start()
    try:
        image, prompt = _req(pipe.config)
        with pytest.raises(RuntimeError, match="transient"):
            srv.submit(image, prompt).result(timeout=10)
        assert srv.submit(image, prompt).result(timeout=30).shape == (3, 8, 8)
        assert srv.stats["errors"] == 1
    finally:
        srv.stop()


def test_bucket_validation_and_stop():
    with pytest.raises(ValueError, match="do not cover max_batch"):
        EditServer(FakePipeline(), ServerConfig(max_batch=4, buckets=(1, 2)))
    assert ServerConfig(max_batch=6).resolved_buckets() == (1, 2, 4, 6)
    pipe = FakePipeline()
    srv = EditServer(pipe, ServerConfig())  # batcher never started
    fut = srv.submit(*_req(pipe.config))
    srv.stop()
    with pytest.raises(RuntimeError, match="shut down"):
        fut.result(timeout=5)
    assert srv.health()["pending"] == 0


def test_group_key_and_config_are_jax():
    fields = [f.name for f in dataclasses.fields(_GroupKey)]
    assert fields == [f.name for f in dataclasses.fields(server_j._GroupKey)]
    for cfg in (ServerConfig(), ServerConfig(max_batch=8), ServerConfig(buckets=(4, 1, 2))):
        want = server_j.ServerConfig(**dataclasses.asdict(cfg))
        assert cfg.resolved_buckets() == want.resolved_buckets()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _serve(srv, **kw):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_mod.make_handler(srv, **kw))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def test_http_error_statuses():
    """400 malformed / 403 guardrail / 413 oversized / 404 through the
    port's handler, on the fake pipeline."""
    pipe = FakePipeline()
    _blocking(pipe)
    srv = EditServer(pipe, ServerConfig(max_wait_ms=5)).start()
    httpd, port = _serve(srv, max_body_mb=1)
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(("image", "prompt_emb"), _req(pipe.config))))
    body = buf.getvalue()
    try:
        assert _post(port, "/edit?seed=notanint", body)[0] == 400
        assert _post(port, "/edit", b"not an npz")[0] == 400
        assert _post(port, "/edit?prompt=forbidden", body)[0] == 403
        assert _post(port, "/edit", b"x" * (1024 * 1024 + 1))[0] == 413
        assert _post(port, "/nope", body)[0] == 404
        status, out = _post(port, "/edit?seed=1", body)
        assert status == 200
        with np.load(io.BytesIO(out)) as z:
            assert z["edit"].shape == (3, 8, 8)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


# ------------------------------------------------------------ tiny pipeline

def _requests(cfg, n=3):
    rng = np.random.default_rng(11)
    d = cfg.dit
    return [dict(image=rng.uniform(-1, 1, (1, 3, 16, 16)).astype(np.float32),
                 prompt_emb=rng.standard_normal((1, 6, d.text_dim)).astype(np.float32),
                 image_emb=rng.standard_normal((1, d.image_tokens, d.image_dim)).astype(np.float32),
                 seed=20 + i) for i in range(n)]


def test_tiny_pipeline_matches_jax_server(pipelines, monkeypatch):
    """Three requests in one window through both servers (one batch padded
    to 4 on each), the port given JAX's draws: each edit within the bar; the
    same request alone in the port matches its batched edit."""
    pipe_j, pipe_t = pipelines
    reqs = _requests(pipe_t.config)
    srv_j = server_j.EditServer(pipe_j, server_j.ServerConfig(max_batch=4, max_wait_ms=200))
    srv_t = EditServer(pipe_t, ServerConfig(max_batch=4, max_wait_ms=200))
    latents_for = srv_t._latents_for
    monkeypatch.setattr(srv_t, "_latents_for", lambda r: torch.from_numpy(
        np.array(srv_j._latents_for(r))))
    futs_j = [srv_j.submit(**r) for r in reqs]
    futs_t = [srv_t.submit(**r) for r in reqs]
    srv_j.start()
    srv_t.start()
    try:
        want = [np.asarray(f.result(timeout=300)) for f in futs_j]
        got = [f.result(timeout=300) for f in futs_t]
        assert srv_t.stats == srv_j.stats
        assert srv_t.stats["batches"] == 1 and srv_t.stats["padded_slots"] == 1
        for g, w in zip(got, want):
            assert g.shape == w.shape == (3, 16, 16)
            assert psnr(g.numpy(), w) >= MIN_PSNR_DB
        alone = srv_t.submit(**reqs[1]).result(timeout=300)
        torch.testing.assert_close(alone, got[1], rtol=BATCH_TOL, atol=BATCH_TOL)
        assert srv_t.stats["batches"] == 2 and srv_t.stats["padded_slots"] == 1
    finally:
        srv_j.stop()
        srv_t.stop()
    # the port's own draws: one seed's noise, whatever else is batched
    lat = latents_for(_queued(20, 16))
    g = torch.Generator().manual_seed(20)
    assert torch.equal(lat, torch.randn(lat.shape, generator=g))


def test_http_endpoint_end_to_end(pipelines):
    """Two concurrent POSTs through the port's handler around the tiny real
    pipeline: finite edits, different seeds give different edits."""
    pipe_t = pipelines[1]
    srv = EditServer(pipe_t, ServerConfig(max_batch=2, max_wait_ms=150)).start()
    httpd, port = _serve(srv)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert b'"pending"' in r.read()
        results = {}

        def post(seed):
            buf = io.BytesIO()
            np.savez(buf, image=np.random.default_rng(seed).uniform(
                -1, 1, (3, 16, 16)).astype(np.float32),
                prompt_emb=np.zeros((6, pipe_t.config.dit.text_dim), np.float32))
            status, out = _post(port, f"/edit?seed={seed}&frame_only=1", buf.getvalue())
            with np.load(io.BytesIO(out)) as z:
                results[seed] = (status, z["edit"])

        threads = [threading.Thread(target=post, args=(s,)) for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        for s in (1, 2):
            assert results[s][0] == 200 and results[s][1].shape == (3, 16, 16)
            assert np.isfinite(results[s][1]).all()
        assert not np.array_equal(results[1][1], results[2][1])
        h = srv.health()
        assert h["requests"] == 2 and h["batches"] >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


def test_submit_time_rejection_matches_jax():
    """The same blocklist rejects the same prompts at submit on both
    servers (neither batcher runs)."""
    cfg = chronoedit_tiny()
    pipe = FakePipeline()
    pipe.guardrails = Guardrails(text=GuardrailRunner([("blocklist", Blocklist())]))

    class JaxFake:
        config, guardrails = cfg, gr_j.Guardrails(text=gr_j.GuardrailRunner(
            [("blocklist", gr_j.Blocklist())]))

    srv_t, srv_j = EditServer(pipe), server_j.EditServer(JaxFake())
    image, prompt = _req(cfg)
    for text in ("a beheading video", "make the cat wear a hat", "r4pe scene"):
        ft, fj = (s.submit(image, prompt, prompt=text) for s in (srv_t, srv_j))
        assert ft.done() == fj.done()
    assert srv_t.stats == srv_j.stats and srv_t.stats["rejected"] == 2
    srv_t.stop()
    srv_j.stop()
