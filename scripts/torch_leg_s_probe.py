"""Is leg S's agreement with leg A (chip_smoke.py) reproducible on the card?

Runs chip_smoke.py's main path up to leg S (the kernels phase, legs A, B,
G and the whole model), then leg A a second time (hashes compared), four
fresh servers on leg A's config, each answer against leg A's token means,
the server's own forward of its pixels in this thread, in a new thread and
beside a 20 GB allocation (hashes compared), and the preprocessing of the
4 volumes three times and from 8 threads (distinct hashes counted).

    python3 scripts/torch_leg_s_probe.py    # on a machine with the card

Logs "probe:" lines; about 3 minutes with the build (ROADMAP queue 3, S1).
"""
import collections
import hashlib
import shutil
import sys
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402


def h(a):
    return hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()[:10]


def main():
    card = cs.phase_device()
    cs.phase_build()
    table = cs.phase_kernels()
    work = cs.ROOT / "chip_smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    vols = cs.write_volumes(work)
    cfg = cs.vit_base_config(work, "leg_a", "auto")
    emb_a, _ = cs.run_leg(work, vols, "A", cfg, [],
                          ("flash_fwd", "mlp_block_fwd"), table)
    paths = [str(p) for p in sorted(vols.glob("*.nii"))]
    ha = [h(np.load(emb_a / f"{Path(p).stem}.npy")) for p in paths]
    cs.log(f"probe: leg A hashes {ha}")
    emb_b, _ = cs.run_leg(work, vols, "B", cs.vit_base_config(
        work, "leg_b", "pallas_bwd"), ["--attn_impl", "pallas_int8"],
        ("flash_fwd_i8", "mlp_fwd", "quantize"), table)
    cs.run_leg_g(work, vols, emb_a, emb_b, table)
    cs.phase_whole_model(vols, emb_a)
    # leg A again, main thread: bitwise?
    a2, _ = cs.run_leg(work, vols, "A2", cfg, [],
                       ("flash_fwd", "mlp_block_fwd"), table)
    ha2 = [h(np.load(a2 / f"{Path(p).stem}.npy")) for p in paths]
    cs.log(f"probe: leg A2 hashes {ha2} equal {ha == ha2}")
    refs = [np.load(emb_a / f"{Path(p).stem}.npy").mean(axis=0)
            for p in paths]

    def worst_vs_a(vecs):
        return max(float(np.abs(vecs[i] - refs[i]).max()
                         / np.abs(refs[i]).max()) for i in range(len(paths)))

    for rep in range(4):
        with cs.serving(config_path=str(cfg),
                        cache_data_dir=str(work / f"sc{rep}")) as srv:
            st, cold, _, split = cs.http_call(srv, "POST", "/embed",
                                              {"images": paths})
            vecs = np.asarray(cold["embeddings"], np.float32)
            cs.log(f"probe: server rep {rep}: status {st} worst vs A "
                   f"{worst_vs_a(vecs):.3e} hashes "
                   f"{[h(v) for v in vecs]}")
            # the service's pieces directly: pixels and tokens
            svc = srv.service
            px, _, _ = svc._preprocess(paths[:2], cache=False)
            out = {}

            def fwd(key):
                t = svc.encoder.encode(svc.encoder.to_device(px))
                out[key] = t.cpu().numpy()
            fwd("main")
            th = threading.Thread(target=fwd, args=("thread",))
            th.start()
            th.join()
            big = torch.empty(int(20e9), dtype=torch.uint8, device="cuda")
            fwd("pressure")
            del big
            cs.log(f"probe: rep {rep} pixels {h(px)} forward hashes "
                   f"{ {k: h(v) for k, v in out.items()} }; tok max|d| "
                   f"main-thread "
                   f"{float(np.abs(out['main'] - out['thread']).max()):.3e}")
    # preprocessing alone, repeated and in threads
    from smb_vision_tpu_torch.data.dataset import CTDataset
    from smb_vision_tpu_torch.data.preprocess import CT_PIPELINES
    pipe = CT_PIPELINES["smb-vision"]
    pipe = type(pipe)(pipe.target_spacing, (512, 512, 320))
    ds = CTDataset(items=[{"image": p} for p in paths], pipeline=pipe,
                   device=torch.device("cuda"))
    hs = collections.defaultdict(set)
    for _ in range(3):
        for i in range(4):
            hs[i].add(h(ds[i]["image"]))
    res = {}

    def load(i):
        res[i] = h(ds[i % 4]["image"])
    ths = [threading.Thread(target=load, args=(i,)) for i in range(8)]
    [t.start() for t in ths]
    [t.join() for t in ths]
    for i, v in res.items():
        hs[i % 4].add(v)
    cs.log(f"probe: preprocess distinct hashes per volume "
           f"{ {i: len(s) for i, s in hs.items()} }")
    print(card)


if __name__ == "__main__":
    main()
