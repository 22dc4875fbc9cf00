"""The port's batching server under a mesh (``pipeline/server.py``:
``EditServer`` on rank 0 broadcasting each batch, ``follow`` on the other
ranks) and ``serve --mesh`` under ``torch.distributed.run``.

The port's side runs in a world of 2 gloo processes (context 2) and one of
4 (tensor 2 x context 2) on the CPU, started together for the file
(``test_torch_serve_workers.py`` through ``parallel.launch.run_world``:
spawned workers, a ``file://`` rendezvous under the test's temporary
directory, each world ended within its own timeout, a barrier after
joining); this process meanwhile runs JAX's ``EditServer`` over JAX's
pipeline under its mesh of the same axes on its 8 CPU devices (as
``tests/test_block_cache.py`` builds one), and the port's server in one
process. JAX draws its noise with ``jax.random.PRNGKey(seed)``, which
torch cannot reproduce, so every rank of the port is given JAX's draws by
seed (``request_latents``, patched in the ranks), as
``test_torch_server.py`` gives them to one process; each rank checks its
initial latents against the other ranks' before every batch
(``check_replica_consistency``). Same weights (``models/from_jax.py``),
fp32, the tiny preset at 16x16, three requests submitted together (one
batch padded to 4) and one of them again alone.

Bars: JAX's server at 60 dB PSNR over the [-1, 1] range
(``test_torch_server.py``'s); the port in one process within 1e-4 (the
context split sums attention, and the tensor split the row products, in
another order: each gives about 1e-6 on these frames); the CLI's frame
bitwise ``run_inference``'s PNG under the same mesh.
"""

import concurrent.futures
import io
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.models import vae as vae_j
from chronoedit_tpu.parallel import MeshConfig as MeshConfigJ
from chronoedit_tpu.parallel import make_mesh as make_mesh_j
from chronoedit_tpu.parallel import shard_params as shard_params_j
from chronoedit_tpu.parallel.sharding import dit_param_sharding as sharding_j
from chronoedit_tpu.pipeline import server as server_j
from chronoedit_tpu.pipeline.edit_pipeline import ChronoEditPipeline as PipeJ
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models import vae as vae_t
from chronoedit_tpu_torch.models.from_jax import load_dit, load_vae
from chronoedit_tpu_torch.parallel.launch import run_world
from chronoedit_tpu_torch.pipeline.edit_pipeline import ChronoEditPipeline as PipeT
from chronoedit_tpu_torch.pipeline.server import EditServer, ServerConfig
from chronoedit_tpu_torch.utils.visualize import to_uint8
from test_torch_dit import randomize
from test_torch_pipeline import psnr
from test_torch_server import _requests
import test_torch_serve_workers as W

torch.set_num_threads(2)

MIN_PSNR_DB = 60.0
ONE_PROCESS_TOL = 1e-4
TIMEOUT = 150.0
REPO = Path(__file__).resolve().parents[1]
# world size: (the port's mesh, JAX's mesh on 8 devices, the planted session)
WORLDS = {2: (dict(context=2), dict(data=4, context=2), "seed+1"),
          4: (dict(tensor=2, context=2), dict(data=2, tensor=2, context=2), "raise")}


def jax_noise(cfg, seed: int) -> np.ndarray:
    """JAX's server's draw for a 16x16 edit (its ``_latents_for``)."""
    tl = cfg.vae.latent_frames(cfg.resolve_num_frames())
    hl = 16 // cfg.vae.spatial_factor
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (1, cfg.latent_channels, tl, hl, hl), jnp.float32))


def serve_all(srv, requests) -> list:
    """The three requests submitted together (one padded batch), then the
    second alone: four frames."""
    futs = [srv.submit(**r) for r in requests]
    srv.start()
    try:
        frames = [np.asarray(f.result(timeout=300)) for f in futs]
        frames.append(np.asarray(srv.submit(**requests[1]).result(timeout=300)))
    finally:
        srv.stop()
    return frames


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({world: [sound session, planted session] by rank}, {world: JAX's
    frames}, the port's frames in one process)."""
    cfg_j, cfg_t = tiny_j(), tiny_t()
    dit_p = randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 5)
    vae_p = randomize(lambda: vae_j.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae), 6,
                      fan_in=lambda s: int(np.prod(s[:-1])))
    requests = _requests(cfg_t)
    noise = {s: jax_noise(cfg_j, s) for s in range(20, 24)}

    dirs = {n: str(tmp_path_factory.mktemp(f"serve{n}")) for n in WORLDS}

    def world(n):
        mesh, _, plant = WORLDS[n]
        got = run_world(W.serve_world, n, (cfg_t, dit_p, vae_p, mesh, noise, requests,
                                           [None, plant]), timeout=TIMEOUT, tmp_dir=dirs[n])
        return [[rank[i] for rank in got] for i in range(2)]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(world, n) for n in WORLDS}
        want = {}
        for n, (_, mesh_cfg, _) in WORLDS.items():
            mesh = make_mesh_j(MeshConfigJ(**mesh_cfg))
            sharded = shard_params_j(dit_p, mesh, sharding_j(mesh))
            srv = server_j.EditServer(PipeJ(cfg_j, sharded, vae_p, mesh=mesh),
                                      server_j.ServerConfig(max_batch=4, max_wait_ms=300))
            want[n] = serve_all(srv, requests)
        one = EditServer(PipeT(cfg_t, load_dit(dit_t.DiT(cfg_t.dit), dit_p),
                               load_vae(vae_t.VAE(cfg_t.vae), vae_p)),
                         ServerConfig(max_batch=4, max_wait_ms=300))
        one._latents_for = lambda r: torch.from_numpy(noise[r.seed].copy())
        alone = serve_all(one, requests)
        return {n: f.result() for n, f in worlds.items()}, want, alone


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_served_frames_match_jax_and_one_process(runs, world):
    """Rank 0 serves the padded batch and the solo request; every frame
    within the bar of JAX's server over its mesh and of the port's server
    in one process; every rank's initial latents alike before every batch;
    ``health()`` reports the mesh; the stop ends every follower's loop
    after the two batches."""
    got, want, alone = runs
    sound = got[world][0]
    r0 = sound[0]
    assert r0["stats"]["batches"] == 2 and r0["stats"]["padded_slots"] == 1
    assert r0["health"]["mesh"] == {"pipe": 1, "data": 1, "fsdp": 1, "tensor": 1, "context": 1,
                                    **WORLDS[world][0]}
    assert r0["health"]["world"] == {"ranks": world, "ended": None}
    for g, w, a in zip(r0["frames"], want[world], alone):
        assert g.shape == w.shape == (3, 16, 16)
        assert psnr(g, w) >= MIN_PSNR_DB
        np.testing.assert_allclose(g, a, atol=ONE_PROCESS_TOL, rtol=0)
    for r in sound:
        assert r["diverged"] == [[], []]
    assert [r["batches"] for r in sound[1:]] == [2] * (world - 1)


def test_follower_drawing_seed_plus_one_fails(runs):
    """A planted follower draws the noise of seed + 1: the replica check
    flags the initial latents before every batch, and the frames miss the
    bars."""
    got, want, alone = runs
    planted = got[2][1]
    for r in planted:
        assert r["diverged"] == [[""], [""]]
    for g, w, a in zip(planted[0]["frames"], want[2], alone):
        assert psnr(g, w) < MIN_PSNR_DB
        assert np.abs(g - a).max() > 100 * ONE_PROCESS_TOL


def test_follower_failure_fails_the_batch_without_a_hang(runs):
    """Rank 1 raises before its first batch: rank 0's future fails with the
    error of its own collective well within the wait, a later request is
    refused at once, health reports the world ended, and every rank
    returns, rank 1 with its own error."""
    got, _, _ = runs
    planted = got[4][1]
    r0 = planted[0]
    assert r0["error"] is not None and "the served world ended in this batch" in r0["error"]
    assert r0["waited"] < W.FUTURE_S / 2
    assert r0["late_done"] and "ended" in r0["late"]
    assert r0["health"]["world"]["ranks"] is None
    assert r0["health"]["world"]["ended"].startswith("rank 0: ")
    assert "planted follower failure" in planted[1]["error"]
    for r in planted[2:]:
        assert r["error"]  # their collectives failed with the world


# an idle world: the process group's timeout, rank 0's keep-alive period
# and the idle time before the request, in seconds
IDLE_PG_TIMEOUT, IDLE_KEEPALIVE, IDLE_S = 4.0, 1.0, 10.0


@pytest.fixture(scope="module")
def idle_runs(tmp_path_factory):
    """{keep-alive period: results by rank} for a world of 2 left idle past
    its process group's timeout: sound, and planted with no keep-alive
    within the idle time."""
    cfg = tiny_t()
    request = {k: v for k, v in _requests(cfg, 1)[0].items()}

    def world(keepalive):
        return run_world(W.idle_world, 2, (cfg, request, keepalive, IDLE_S), timeout=90.0,
                         tmp_dir=str(tmp_path_factory.mktemp("idle")),
                         pg_timeout=IDLE_PG_TIMEOUT)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = {k: pool.submit(world, k) for k in (IDLE_KEEPALIVE, 10 * IDLE_S)}
        return {k: f.result() for k, f in jobs.items()}, request


def test_idle_world_stays_up_and_serves(idle_runs):
    """Idle for 2.5 process-group timeouts: rank 0's keep-alive headers
    hold the follower's wait, and the request that follows is served (the
    stand-in pipeline's frame) by both ranks."""
    got, request = idle_runs
    r0, r1 = got[IDLE_KEEPALIVE]
    assert "error" not in r0 and "error" not in r1, (r0.get("error"), r1.get("error"))
    assert r0["keepalives"] >= IDLE_S / IDLE_KEEPALIVE / 2
    assert r0["health"]["world"] == {"ranks": 2, "ended": None}
    np.testing.assert_array_equal(r0["frame"].shape, (3, 16, 16))
    assert np.isfinite(r0["frame"]).all()
    assert r1["batches"] == 1


def test_idle_world_without_keepalive_ends(idle_runs):
    """Planted: no keep-alive within the idle time. The follower's wait
    times out, and the request that follows fails on rank 0 within the
    process group's timeout, not a hang: the check above is what keeps an
    idle world up."""
    got, _ = idle_runs
    r0, r1 = got[10 * IDLE_S]
    assert r0["keepalives"] == 0
    assert "Timed out" in r1["error"]
    assert "error" in r0 and "the served world ended" in r0["error"]
    assert r0["waited"] < 3 * IDLE_PG_TIMEOUT
    assert r0["health"]["world"]["ended"].startswith("rank 0: ")


def test_serve_mesh_cli_under_torchrun(tmp_path):
    """``serve --mesh context=2 --smoke --device cpu`` under ``torch.distributed.run
    --nproc-per-node 2``: /healthz reports the mesh; one /edit equals the
    frame ``run_inference --mesh context=2 --smoke`` writes for the same
    inputs and seed; after SIGTERM every rank exits within 30 s (rank 1
    leaves on rank 0's stop)."""
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m"]
    ref = subprocess.run([*run, "chronoedit_tpu_torch.scripts.run_inference", "--smoke",
                          "--device", "cpu", "--mesh", "context=2", "--output",
                          str(tmp_path / "ref.png")],
                         cwd=REPO, capture_output=True, text=True, timeout=240)
    assert ref.returncode == 0, ref.stdout[-3000:] + ref.stderr[-3000:]
    log = open(tmp_path / "serve.log", "w+")
    proc = subprocess.Popen([*run, "chronoedit_tpu_torch.scripts.serve", "--mesh", "context=2",
                             "--smoke", "--device", "cpu", "--port", "0", "--max-wait-ms", "5"],
                            cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        deadline = time.monotonic() + 180
        while port is None and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.5)
            log.seek(0)
            for line in log:
                if "listening on" in line:
                    port = int(line.split(":")[1].split()[0])
        assert port is not None, open(tmp_path / "serve.log").read()[-3000:]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = __import__("json").loads(r.read())
        assert health["mesh"]["context"] == 2 and health["world"]["ranks"] == 2
        # run_inference --smoke's inputs (scripts/run_inference.py)
        cfg, cpu = tiny_t(), torch.device("cpu")
        image = torch.rand((1, 3, 32, 32), generator=torch.Generator(cpu).manual_seed(7)) * 2 - 1
        emb = [torch.randn((1, 8, cfg.dit.text_dim), generator=torch.Generator(cpu).manual_seed(s))
               for s in (1, 2)]
        image_emb = torch.randn((1, cfg.dit.image_tokens, cfg.dit.image_dim),
                                generator=torch.Generator(cpu).manual_seed(3))
        buf = io.BytesIO()
        np.savez(buf, image=image.numpy(), prompt_emb=emb[0].numpy(),
                 neg_prompt_emb=emb[1].numpy(), image_emb=image_emb.numpy())
        req = urllib.request.Request(f"http://127.0.0.1:{port}/edit?seed=0", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            with np.load(io.BytesIO(r.read())) as z:
                edit = z["edit"]
        want = np.asarray(Image.open(tmp_path / "ref.png"))
        assert want.std() > 0
        np.testing.assert_array_equal(to_uint8(edit), want)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log.seek(0)
    text = log.read()
    assert "rank 1: stopped after 1 batches" in text, text[-3000:]
