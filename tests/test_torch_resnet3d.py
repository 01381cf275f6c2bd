"""The port's inflated-3D ResNet (`models/resnet3d.py`, Merlin's image
tower), its converters, `MerlinEncoder`, `run_encoders --encoder merlin`
and `serve --encoder merlin` on the CPU: the counterparts of
tests/test_resnet3d.py and of tests/test_serve.py's Merlin case, each
against the JAX package (float32 at 2e-4; the bf16 CLIs at 3e-2 of
max)."""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from smb_vision_tpu.models import convert as jconvert
from smb_vision_tpu.models.configs import ResNet3DConfig as JConfig
from smb_vision_tpu.models.resnet3d import ResNet3D as JResNet3D
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import ResNet3DConfig
from smb_vision_tpu_torch.models.resnet3d import ResNet3D
from smb_vision_tpu_torch.train.optim import is_decayed

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(stage_sizes=(1, 1, 1, 1), base_width=8, num_channels=1)
PREFIX = "encode_image.i3_resnet."


def _torch_state(cfg, seed=0, prefix=""):
    """A torchvision-schema 3D state dict of cfg's tower with random
    convolutions and non-trivial BN affines and running statistics."""
    model = ResNet3D(cfg).init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            f = b.numel()
            b.copy_(torch.from_numpy({
                "weight": rng.uniform(0.5, 1.5, f),
                "bias": rng.normal(0, 0.2, f),
                "mean": rng.normal(0, 0.3, f),
                "var": rng.uniform(0.5, 2.0, f)}[name.rsplit(".", 1)[1]]
                .astype(np.float32)))
        if model.head is not None:
            model.head.weight.normal_(0, 0.1, generator=torch.Generator()
                                      .manual_seed(seed))
    sd = convert.export_torch_resnet3d(model.state_dict(), cfg)
    return {prefix + k: v for k, v in sd.items()}


def _pair(cfg_kw, seed=0):
    """(JAX tower, its params, the port's tower) from one torch state."""
    cfg = ResNet3DConfig(**cfg_kw)
    sd = _torch_state(cfg, seed)
    jcfg = JConfig(**cfg_kw)
    params = jconvert.convert_torch_resnet3d(sd, jcfg)
    model = ResNet3D(cfg)
    model.load_state_dict(convert.params_from_flax(
        convert.convert_torch_resnet3d(sd, cfg), whole=True))
    return JResNet3D(jcfg), params, model.eval()


def test_tower_matches_jax():
    """Stage sizes (1, 1, 1, 1), base width 8, a 32^3 volume, float32:
    tokens ((a0, a1, a2) order, channels last) and pooled output within
    2e-4 of the JAX tower's."""
    jmodel, params, model = _pair(dict(TINY, dtype="float32"))
    px = np.random.default_rng(1).normal(size=(2, 1, 32, 32, 32)).astype(
        np.float32)
    with torch.no_grad():
        tokens, pooled = model(torch.from_numpy(px))
    jt, jp = jax.jit(jmodel.apply)(params, px)
    assert tuple(tokens.shape) == (2, 1, 256)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jp), **TOL)


def test_config_from_shapes_and_prefixed_convert():
    """Under Merlin's nesting, with a text tower's keys beside it: the
    config read from the shapes and the converted tensors equal the JAX
    package's."""
    cfg = ResNet3DConfig(stage_sizes=(1, 2), base_width=8, stem_kernel_t=3,
                         conv2_kernel_t=1, num_labels=3)
    sd = _torch_state(cfg, prefix=PREFIX)
    sd["encode_text.proj.weight"] = np.zeros((4, 4), np.float32)
    got = convert.resnet3d_config_from_state_dict(sd)
    want = jconvert.resnet3d_config_from_state_dict(sd)
    assert got.to_dict() == {**want.to_dict(),
                             "stage_sizes": tuple(want.stage_sizes)}
    assert got.stage_sizes == (1, 2) and got.num_labels == 3
    ours = convert.convert_torch_resnet3d(sd, got)
    ref = flatten_params(jconvert.convert_torch_resnet3d(sd, want))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), k)


def test_partial_checkpoint_rejected():
    cfg = ResNet3DConfig(**TINY)
    sd = _torch_state(cfg)
    del sd["layer3.0.bn2.running_var"]
    with pytest.raises(KeyError, match="missing layer3.0.bn2.running_var"):
        convert.convert_torch_resnet3d(sd, cfg)


@pytest.mark.parametrize("mode", ["center", "average"])
def test_inflation_matches_jax(mode):
    """inflate_resnet2d: the same 3D arrays as the JAX package's, bit for
    bit, in either mode; an unknown mode raises."""
    rng = np.random.default_rng(2)
    cfg = ResNet3DConfig(stage_sizes=(1, 1), base_width=8,
                         temporal_downsample=False, stem_stride_t=1,
                         pool_stride_t=1, dtype="float32")
    sd3 = _torch_state(cfg)
    sd2 = {k: (v[:, :, 0] * 1.0 + rng.normal(0, 0.01, v[:, :, 0].shape)
               ).astype(np.float32) if v.ndim == 5 else v
           for k, v in sd3.items()}
    kw = dict(stem_kernel_t=3, conv2_kernel_t=3, mode=mode)
    got = convert.inflate_resnet2d(sd2, **kw)
    want = jconvert.inflate_resnet2d(sd2, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    with pytest.raises(ValueError, match="inflation mode"):
        convert.inflate_resnet2d(sd2, mode="edge")


def test_classifier_head_and_bad_inputs():
    jmodel, params, model = _pair(dict(TINY, dtype="float32", num_labels=3))
    px = np.random.default_rng(3).normal(size=(1, 1, 16, 32, 24)).astype(
        np.float32)
    with torch.no_grad():
        tokens, pooled, logits = model(torch.from_numpy(px))
    assert tuple(logits.shape) == (1, 3)
    _, _, jlogits = jax.jit(jmodel.apply)(params, px)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    with pytest.raises(ValueError, match="a0, a1, a2"):
        model(torch.from_numpy(px[0]))
    with pytest.raises(ValueError, match="no inflated-3D resnet"):
        convert.resnet3d_config_from_state_dict(
            {"x.weight": np.zeros((2, 2), np.float32)})


def test_frozen_bn_gets_no_gradient_and_no_decay():
    """The frozen BatchNorm statistics and affine are buffers: no
    gradient reaches them, they are not in named_parameters, and
    `is_decayed` exempts their names, the port's and the JAX package's."""
    from smb_vision_tpu.train.optim import decay_mask

    cfg = ResNet3DConfig(**TINY, dtype="float32", num_labels=2)
    model = ResNet3D(cfg).init_weights(torch.Generator().manual_seed(0))
    px = torch.randn(1, 1, 16, 32, 24, generator=torch.Generator()
                     .manual_seed(1))
    (model(px)[2] ** 2).sum().backward()
    names = [n for n, _ in model.named_parameters()]
    assert not any(".bn." in n for n in names)
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in model.parameters())
    bn = [n for n, _ in model.named_buffers()]
    assert bn and all(".bn." in n for n in bn)
    assert not any(is_decayed(n) for n in bn)
    assert all(is_decayed(n) for n in names if n.endswith(".weight"))
    jparams = convert.params_to_flax(model.state_dict())
    jtree = jax.tree_util.tree_map(np.asarray, jconvert.unflatten_params(
        jparams))
    for path, decayed in jax.tree_util.tree_leaves_with_path(
            decay_mask(jtree)):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        assert is_decayed(name) == bool(decayed), name


def test_export_torch_roundtrip():
    """The port's state_dict -> torch schema: bit for bit the JAX
    package's export of the same weights, and back."""
    cfg = ResNet3DConfig(**TINY, num_labels=3)
    jcfg = JConfig(**TINY, num_labels=3)
    sd = _torch_state(cfg, seed=4)
    model = ResNet3D(cfg)
    model.load_state_dict(convert.params_from_flax(
        convert.convert_torch_resnet3d(sd, cfg), whole=True))
    got = convert.export_torch_resnet3d(model.state_dict(), cfg)
    want = jconvert.export_torch_resnet3d(
        jconvert.convert_torch_resnet3d(sd, jcfg), jcfg)
    assert set(got) == set(want) == set(sd)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
        np.testing.assert_array_equal(got[k], sd[k], k)


def _volumes(tmp_path, uids, seed=5, shape=(24, 24, 16)):
    from smb_vision_tpu_torch.data.nifti import save_nifti

    rng = np.random.default_rng(seed)
    items = []
    for uid in uids:
        p = tmp_path / f"{uid}.nii.gz"
        save_nifti(p, rng.normal(0, 300, shape).astype(np.float32))
        items.append({"uid": uid, "image_path": str(p)})
    return items


def _merlin_ckpt(tmp_path, cfg_kw=TINY):
    sd = _torch_state(ResNet3DConfig(**cfg_kw), seed=6, prefix=PREFIX)
    path = tmp_path / "merlin.safetensors"
    convert.write_safetensors(path, sd)
    return str(path)


def test_merlin_encoder_float_and_uint8(tmp_path):
    """MerlinEncoder (backend "jax": the port's tower) at float32 against
    the JAX encoder on the same volumes through each package's "merlin"
    pipeline (within 2e-4 of max), and on uint8 codes decoded on the
    device against the JAX uint8 route on the same codes (1e-4)."""
    from smb_vision_tpu.inference.encoders import MerlinEncoder as JMerlin
    from smb_vision_tpu_torch.inference.encoders import MerlinEncoder

    ckpt = _merlin_ckpt(tmp_path)
    items = _volumes(tmp_path, ["a", "b"])
    kw = dict(checkpoint=ckpt, dtype="float32", target_size=(32, 32, 24))
    enc = MerlinEncoder(**kw, device="cpu")
    ref = JMerlin(**kw)
    enc.setup_model()
    ref.setup_model()
    assert enc.config.hidden_size == 256
    px = np.stack([enc.create_dataset(items)[i]["image"] for i in range(2)])
    jpx = np.stack([ref.create_dataset(items)[i]["image"] for i in range(2)])
    assert px.shape == (2, 1, 32, 32, 24)
    np.testing.assert_allclose(px, jpx, atol=1e-4)
    got = enc.generate_embedding(px)
    want = ref.generate_embedding(jpx)
    assert got.shape == want.shape and got.shape[::2] == (2, 256)
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    ds8 = enc.create_dataset(items, out_dtype="uint8")
    exs = [ds8[i] for i in range(2)]
    q = np.stack([np.asarray(e["image"]) for e in exs])
    sc = np.asarray([e["image_scale"] for e in exs], np.float32)
    of = np.asarray([e["image_offset"] for e in exs], np.float32)
    assert q.dtype == np.uint8
    got8 = enc.generate_embedding(q, scale=sc, offset=of)
    want8 = ref.generate_embedding(q, scale=sc, offset=of)
    assert np.abs(got8 - want8).max() <= 1e-4 * np.abs(want8).max()


def test_merlin_encoder_backend_gates():
    from smb_vision_tpu_torch.inference.encoders import MerlinEncoder

    with pytest.raises(ValueError, match="backend"):
        MerlinEncoder(backend="tf", device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        MerlinEncoder(backend="jax", device="cpu").setup_model()
    with pytest.raises(RuntimeError, match="merlin"):
        MerlinEncoder(backend="torch", device="cpu").setup_model()


def test_run_encoders_merlin_cli_matches_jax(tmp_path):
    """manifest -> the port's I3D tower -> one parquet per uid, within
    3e-2 of max of the JAX CLI's vectors (bf16 both); resume skips every
    uid; --checkpoint and a 3-int --target_size are required."""
    import pandas as pd

    from smb_vision_tpu.cli.run_encoders import main as jmain
    from smb_vision_tpu_torch.cli.run_encoders import main

    ckpt = _merlin_ckpt(tmp_path)
    items = _volumes(tmp_path, ["ct-1", "ct-2", "ct-3"], shape=(20, 20, 12))
    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({"images": items}))

    def argv(out):
        return ["--encoder", "merlin", "--checkpoint", ckpt, "--input_json",
                str(manifest), "--output_dir", str(out), "--batch_size", "2",
                "--merlin_backend", "jax", "--target_size", "32,32,24"]

    cpu = ["--device", "cpu"]
    assert main(argv(tmp_path / "emb") + cpu)["embedded"] == 3
    jmain(argv(tmp_path / "jemb"))
    for uid in ("ct-1", "ct-2", "ct-3"):
        got = pd.read_parquet(tmp_path / "emb" / "model_id=merlin"
                              / f"{uid}.parquet").iloc[0]
        want = pd.read_parquet(tmp_path / "jemb" / "model_id=merlin"
                               / f"{uid}.parquet").iloc[0]
        assert list(got["embedding_shape"]) == list(want["embedding_shape"])
        g, w = np.asarray(got["embedding"]), np.asarray(want["embedding"])
        assert np.abs(g - w).max() <= 3e-2 * np.abs(w).max(), uid
    assert main(argv(tmp_path / "emb") + cpu)["skipped"] == 3
    with pytest.raises(SystemExit, match="checkpoint"):
        main(["--encoder", "merlin", "--merlin_backend", "jax",
              "--input_json", str(manifest)] + cpu)
    with pytest.raises(SystemExit, match="target_size"):
        main(argv(tmp_path / "x")[:-1] + ["32,32,x"] + cpu)


def _request(srv, method, path, body=None):
    import http.client

    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None)
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def test_serve_merlin_encoder(tmp_path):
    """serve --encoder merlin at --device cpu, as the JAX package's
    test_serve_merlin_encoder: /healthz reports the tower, /embed answers
    the mean-pooled vectors of a direct forward (2e-5) and of the JAX
    server on the same checkpoint and volumes (2e-4 of max); uint8
    shipping within 5e-2; a missing checkpoint raises."""
    from smb_vision_tpu.cli.serve import ServeArguments as JArgs
    from smb_vision_tpu.cli.serve import make_server as jmake
    from smb_vision_tpu_torch.cli.serve import ServeArguments, make_server

    ckpt = _merlin_ckpt(tmp_path, dict(TINY, stage_sizes=(1, 1)))
    paths = [it["image_path"] for it in _volumes(tmp_path, ["v0", "v1"])]
    kw = dict(host="127.0.0.1", port=0, encoder="merlin",
              model_name_or_path=ckpt, dtype="float32", batch_size=2,
              target_size="32,32,24")
    answers = {}
    for name, srv in (("port", make_server(ServeArguments(**kw,
                                                          device="cpu"))),
                      ("jax", jmake(JArgs(**kw))),
                      ("uint8", make_server(ServeArguments(
                          **kw, device="cpu", input_dtype="uint8")))):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            status, health = _request(srv, "GET", "/healthz")
            assert status == 200 and health["encoder"] == "merlin"
            assert health["hidden_size"] == 64
            assert health["pixel_shape"] == [1, 32, 32, 24]
            status, out = _request(srv, "POST", "/embed", {"images": paths})
            assert status == 200 and out["shape"] == [2, 64]
            answers[name] = np.asarray(out["embeddings"])
            if name == "port":
                svc = srv.service
                px, _, _ = svc._preprocess(paths)
                direct = svc.encoder.generate_embedding(px).mean(axis=1)
                np.testing.assert_allclose(answers[name], direct,
                                           rtol=2e-5, atol=2e-5)
        finally:
            srv.shutdown()
            srv.server_close()
    want = answers["jax"]
    assert np.abs(answers["port"] - want).max() <= 2e-4 * np.abs(want).max()
    np.testing.assert_allclose(answers["uint8"], answers["port"], rtol=0.05,
                               atol=0.05)
    with pytest.raises(ValueError, match="model_name_or_path"):
        make_server(ServeArguments(encoder="merlin", port=0, device="cpu"))
