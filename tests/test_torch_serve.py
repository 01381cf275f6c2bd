"""The PyTorch port's embedding server (cli/serve.py) and the encoder it
drives (inference/runner.py) on the CPU: every case of tests/test_serve.py
but the Merlin tower, through real HTTP against a live server, one answer
against the JAX package's EmbeddingService on the same exported
checkpoint, and the encoder against the JAX package's SmbVisionEncoder."""

import concurrent.futures
import http.client
import json
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.videomae import VideoMAEModel as JModel
from smb_vision_tpu.utils.serialization import save_params_safetensors
from smb_vision_tpu_torch.cli.serve import (
    ServeArguments,
    make_server,
    server_timing,
)
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.inference.runner import SmbVisionEncoder

torch.set_num_threads(1)

CFG = {"image_size": 32, "num_frames": 32, "patch_size": 16,
       "tubelet_size": 16, "num_channels": 1, "hidden_size": 32,
       "num_hidden_layers": 1, "num_attention_heads": 2,
       "intermediate_size": 64}


def _start(**kw):
    kw = {"host": "127.0.0.1", "port": 0, "dtype": "float32",
          "attn_impl": "xla", "batch_size": 2, "device": "cpu", **kw}
    srv = make_server(ServeArguments(**kw))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """3 NIfTI volumes, the config and the JAX export of random weights."""
    root = tmp_path_factory.mktemp("torch_serve")
    rng = np.random.default_rng(0)
    for i in range(3):
        vol = rng.normal(0, 300, (32, 32, 32)).astype(np.int16)
        save_nifti(root / f"case_{i}.nii.gz", vol,
                   np.diag([1.5, 1.5, 3.0, 1.0]))
    (root / "config.json").write_text(json.dumps(CFG))
    params = jax.jit(JModel(JConfig(**CFG)).init)(
        jax.random.PRNGKey(0), np.zeros((1, 32, 1, 32, 32), np.float32))
    params = jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 else p, params)
    save_params_safetensors(params, root / "model.safetensors")
    return root


@pytest.fixture(scope="module")
def server(root):
    srv = _start(config_path=str(root / "config.json"),
                 cache_data_dir=str(root / "cache"))
    yield srv, [str(root / f"case_{i}.nii.gz") for i in range(3)]
    srv.shutdown()
    srv.server_close()


def _request(srv, method, path, body=None):
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None)
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def test_healthz(server):
    srv, _ = server
    status, out = _request(srv, "GET", "/healthz")
    assert status == 200
    assert out["status"] == "ok" and out["device"] == "cpu"
    assert out["grid"] == [2, 2, 2] and out["hidden_size"] == 32


def test_embed_single_matches_direct(server):
    srv, paths = server
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/embed", body=json.dumps({"image": paths[0]}))
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    assert resp.status == 200
    assert out["shape"] == [1, 32]          # mean-pooled (N, D)
    svc = srv.service
    px, _, _ = svc._preprocess([paths[0], paths[0]])  # the model's batch: 2
    direct = svc.encoder.generate_embedding(px)[0].mean(axis=0)
    np.testing.assert_allclose(np.asarray(out["embeddings"][0]), direct,
                               rtol=2e-5, atol=2e-5)
    # the answer carries its own time split, read with the answer itself
    split = server_timing(resp.getheader("Server-Timing"))
    assert set(split) == {"preprocess_ms", "copy_ms", "encode_ms",
                          "serialize_ms"}
    assert all(v >= 0 for v in split.values())


def test_embed_batch_pads_and_chunks(server):
    """3 volumes through a batch of 2: a chunk of 2, then 1 padded."""
    srv, paths = server
    status, out = _request(srv, "POST", "/embed", {"images": paths})
    assert status == 200
    assert out["shape"] == [3, 32]
    emb = np.asarray(out["embeddings"])
    assert np.abs(emb[0] - emb[1]).max() > 1e-6
    _, one = _request(srv, "POST", "/embed", {"image": paths[2]})
    np.testing.assert_allclose(emb[2], np.asarray(one["embeddings"][0]),
                               rtol=2e-5, atol=2e-5)


def test_embed_pool_none_returns_tokens(server):
    srv, paths = server
    status, out = _request(srv, "POST", "/embed",
                           {"image": paths[0], "pool": "none"})
    assert status == 200
    assert out["shape"] == [1, 8, 32]       # (N, tokens, D)
    _, pooled = _request(srv, "POST", "/embed", {"image": paths[0]})
    np.testing.assert_allclose(np.asarray(out["embeddings"][0]).mean(0),
                               pooled["embeddings"][0], atol=1e-6)


def test_embed_raw_nifti_bytes(server):
    """Raw NIfTI bytes (octet-stream): the path route's answer, and no
    cache entry written for the temporary file."""
    srv, paths = server
    cache = srv.service.args.cache_data_dir
    _, by_path = _request(srv, "POST", "/embed", {"image": paths[0]})
    n_cached = len(list(Path(cache).iterdir()))
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/embed?pool=mean", body=open(paths[0], "rb").read(),
                 headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    raw = json.loads(resp.read())
    conn.close()
    assert resp.status == 200 and raw["shape"] == [1, 32]
    assert "encode_ms" in server_timing(resp.getheader("Server-Timing"))
    np.testing.assert_allclose(np.asarray(raw["embeddings"]),
                               np.asarray(by_path["embeddings"]),
                               rtol=2e-5, atol=2e-5)
    assert len(list(Path(cache).iterdir())) == n_cached


def test_embed_cache_hit_skips_preprocessing(server, monkeypatch):
    """A repeated path is read from the cache: no NIfTI decode."""
    srv, paths = server
    _, first = _request(srv, "POST", "/embed", {"images": paths[:2]})
    import smb_vision_tpu_torch.data.dataset as D

    def no_decode(path):
        raise AssertionError(f"decoded {path} despite the cache")

    monkeypatch.setattr(D, "load_nifti", no_decode)
    status, again = _request(srv, "POST", "/embed", {"images": paths[:2]})
    assert status == 200
    np.testing.assert_array_equal(again["embeddings"], first["embeddings"])


def test_embed_uint8_input_dtype(server, tmp_path):
    """--input_dtype uint8: one byte a voxel, decoded on the device; the
    vectors track the float32 server's."""
    srv, paths = server
    srv8 = _start(config_path=srv.service.args.config_path,
                  input_dtype="uint8", cache_data_dir=str(tmp_path / "c8"))
    try:
        status, health = _request(srv8, "GET", "/healthz")
        assert status == 200 and health["input_dtype"] == "uint8"
        status, out8 = _request(srv8, "POST", "/embed", {"images": paths})
        assert status == 200 and out8["shape"] == [3, 32]
        _, outf = _request(srv, "POST", "/embed", {"images": paths})
        a, b = np.asarray(out8["embeddings"]), np.asarray(outf["embeddings"])
        assert np.abs(a - b).max() / np.abs(b).max() < 0.05
        # the cache holds the codes; a second request reads them back
        _, again = _request(srv8, "POST", "/embed", {"images": paths})
        np.testing.assert_array_equal(again["embeddings"], out8["embeddings"])
    finally:
        srv8.shutdown()
        srv8.server_close()


def test_embed_errors(server):
    srv, paths = server
    status, out = _request(srv, "POST", "/embed", {})
    assert status == 400 and "image" in out["error"]
    status, out = _request(srv, "POST", "/embed",
                           {"image": paths[0], "pool": "max"})
    assert status == 400 and "pool" in out["error"]
    status, out = _request(srv, "POST", "/embed",
                           {"image": "/nonexistent.nii.gz"})
    assert status in (400, 404) and "nonexistent" in out["error"]
    status, _ = _request(srv, "GET", "/nope")
    assert status == 404
    status, _ = _request(srv, "POST", "/nope", {})
    assert status == 404


def test_embed_malformed_bodies(server):
    srv, paths = server
    status, out = _request(srv, "POST", "/embed", [{"image": paths[0]}])
    assert status == 400 and "JSON object" in out["error"]
    status, out = _request(srv, "POST", "/embed", "just a string")
    assert status == 400
    status, out = _request(srv, "POST", "/embed", {"images": 17})
    assert status == 400
    status, out = _request(srv, "POST", "/embed", {"images": [1, 2]})
    assert status == 400
    status, out = _request(srv, "POST", "/embed", {"images": paths[0]})
    assert status == 200 and out["shape"][0] == 1


def test_embed_concurrent_overlapping_requests(server):
    """12 threads at once: mixed single and multi-volume embeds (their
    chunks interleave under the device lock) and health polls. Every
    answer is 200, every vector the serial answer for its volume, and
    requests_served counts every volume once."""
    srv, paths = server
    base = _request(srv, "POST", "/embed", {"image": paths[0]})[1]
    base1 = _request(srv, "POST", "/embed", {"image": paths[1]})[1]
    served0 = _request(srv, "GET", "/healthz")[1]["requests_served"]

    jobs = []
    for i in range(12):
        if i % 3 == 0:
            jobs.append(("POST", "/embed", {"images": [paths[1], paths[0],
                                                       paths[2]]}))
        elif i % 3 == 1:
            jobs.append(("POST", "/embed", {"image": paths[i % 2]}))
        else:
            jobs.append(("GET", "/healthz", None))

    with concurrent.futures.ThreadPoolExecutor(max_workers=12) as ex:
        results = list(ex.map(lambda j: _request(srv, *j), jobs))

    n_vols = 0
    for (method, path, body), (status, out) in zip(jobs, results):
        assert status == 200, (path, out)
        if path == "/healthz":
            assert out["status"] == "ok"
            continue
        n_vols += len(out["embeddings"])
        if "images" in body:
            got0, got1 = out["embeddings"][1], out["embeddings"][0]
        elif body["image"] == paths[0]:
            got0, got1 = out["embeddings"][0], None
        else:
            got0, got1 = None, out["embeddings"][0]
        if got0 is not None:
            np.testing.assert_allclose(got0, base["embeddings"][0],
                                       rtol=1e-5, atol=1e-6)
        if got1 is not None:
            np.testing.assert_allclose(got1, base1["embeddings"][0],
                                       rtol=1e-5, atol=1e-6)
    served1 = _request(srv, "GET", "/healthz")[1]["requests_served"]
    assert served1 - served0 == n_vols


def test_embed_matches_jax_service(root):
    """The same exported checkpoint and NIfTI through the JAX package's
    EmbeddingService and the port's: the same vectors and token grids."""
    from smb_vision_tpu.cli.serve import EmbeddingService as JService
    from smb_vision_tpu.cli.serve import ServeArguments as JArgs
    from smb_vision_tpu_torch.cli.serve import EmbeddingService

    kw = dict(config_path=str(root / "config.json"),
              model_name_or_path=str(root / "model.safetensors"),
              dtype="float32", attn_impl="xla", batch_size=2, warmup=False)
    paths = [str(root / f"case_{i}.nii.gz") for i in (0, 2, 1)]
    jsvc, tsvc = JService(JArgs(**kw)), EmbeddingService(
        ServeArguments(device="cpu", **kw))
    for pool in ("mean", "none"):
        ref = np.asarray(jsvc.embed(paths, pool=pool))
        out = tsvc.embed(paths, pool=pool)
        assert out.shape == ref.shape and out.dtype == np.float32
        np.testing.assert_allclose(out, ref, atol=1e-4)
    assert tsvc.health().keys() == jsvc.health().keys()


def test_serve_refusals(root, monkeypatch):
    # --encoder merlin is ported: it needs its checkpoint
    with pytest.raises(ValueError, match="model_name_or_path"):
        make_server(ServeArguments(encoder="merlin", port=0, device="cpu"))
    with pytest.raises(ValueError, match="unknown encoder"):
        make_server(ServeArguments(encoder="clip", port=0, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        make_server(ServeArguments(config_path=str(root / "config.json"),
                                   port=0))


def test_serve_main_parses_flags(root, monkeypatch):
    """The module's main() builds the server from CLI flags."""
    import smb_vision_tpu_torch.cli.serve as S

    seen = {}

    def fake_make_server(args):
        seen["args"] = args
        raise KeyboardInterrupt

    monkeypatch.setattr(S, "make_server", fake_make_server)
    with pytest.raises(KeyboardInterrupt):
        S.main(["--config_path", str(root / "config.json"), "--device",
                "cpu", "--batch_size", "3", "--input_dtype", "uint8",
                "--seed", "5", "--warmup", "false"])
    a = seen["args"]
    assert (a.device, a.batch_size, a.input_dtype, a.seed, a.warmup) == (
        "cpu", 3, "uint8", 5, False)


# --- the encoder the server drives ---------------------------------------


def _mk_volumes(tmp_path, rng, n=3):
    items = []
    for i in range(n):
        p = tmp_path / f"v{i}.nii.gz"
        save_nifti(p, rng.normal(0, 300, (24, 24, 16)).astype(np.float32))
        items.append({"uid": f"v{i}", "image_path": str(p)})
    return items


@pytest.mark.parametrize("input_dtype", ["float32", "uint8"])
def test_smb_vision_encoder_matches_jax(tmp_path, input_dtype):
    """The same exported weights and NIfTIs through the JAX package's
    SmbVisionEncoder and the port's: the same token grids, from float
    pixels and from uint8 codes with their affine; a missing file raises
    when its item is read, not when the dataset is built."""
    from smb_vision_tpu.inference.runner import (
        SmbVisionEncoder as JEncoder,
    )

    cfg = dict(image_size=16, num_frames=16, patch_size=8, tubelet_size=8,
               num_channels=1, hidden_size=32, num_hidden_layers=1,
               num_attention_heads=2, intermediate_size=64)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    params = jax.jit(JModel(JConfig(**cfg)).init)(
        jax.random.PRNGKey(1), np.zeros((1, 16, 1, 16, 16), np.float32))
    save_params_safetensors(params, tmp_path / "model.safetensors")
    items = _mk_volumes(tmp_path, np.random.default_rng(0))
    kw = dict(config_path=str(tmp_path / "config.json"),
              checkpoint=str(tmp_path / "model.safetensors"),
              model_id="test-enc", dtype="float32", attn_impl="xla")
    enc, jenc = SmbVisionEncoder(device="cpu", **kw), JEncoder(**kw)
    enc.setup_model()
    jenc.setup_model()

    def batch(ds):
        exs = [ds[i] for i in range(len(items))]
        px = np.stack([e["image"] for e in exs])
        if input_dtype == "uint8":
            return px, {k: np.asarray([e[f"image_{k}"] for e in exs],
                                      np.float32)
                        for k in ("scale", "offset")}
        return px, {}

    px, aff = batch(enc.create_dataset(items, out_dtype=input_dtype))
    jpx, jaff = batch(jenc.create_dataset(items, out_dtype=input_dtype))
    assert px.dtype == np.dtype(input_dtype)
    out = enc.generate_embedding(px, **aff)
    ref = jenc.generate_embedding(jpx, **jaff)
    assert out.shape == ref.shape == (3, 8, 32) and out.dtype == np.float32
    # the two preprocessors agree to 1e-5; a uint8 code at a rounding tie
    # may move by one step (tests/test_torch_cli.py, TOL_UINT8_VS_JAX)
    tol = 1e-4 if input_dtype == "float32" else 5e-3 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=tol)

    ds = enc.create_dataset([{"uid": "x", "image_path": str(
        tmp_path / "no.nii")}])
    with pytest.raises(FileNotFoundError):
        ds[0]


def test_create_dataset_cache_dir(tmp_path):
    """create_dataset(cache_dir=...) keeps one entry a volume there, at the
    model's grid; without it nothing is written."""
    (tmp_path / "config.json").write_text(json.dumps(CFG))
    enc = SmbVisionEncoder(config_path=str(tmp_path / "config.json"),
                           device="cpu")
    items = _mk_volumes(tmp_path, np.random.default_rng(1), n=2)
    plain = enc.create_dataset(items)
    cached = enc.create_dataset(items, cache_dir=str(tmp_path / "c"))
    assert plain.cache_dir is None
    for i in range(2):
        np.testing.assert_array_equal(cached[i]["image"], plain[i]["image"])
    assert cached[0]["image"].shape == (32, 1, 32, 32)
    assert len(list((tmp_path / "c").glob("*.npy"))) == 2
