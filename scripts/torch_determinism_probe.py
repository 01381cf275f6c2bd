"""Are K1, K2 and the whole ViT-Base forward bit for bit reproducible on
the card, alone and beside another process that loads it?

K1 (flash_attention) 400 times at chip_smoke.py's main shape, K2
(mlp_block_fused) 300 times at two volumes' rows, and the 12-layer
ViT-Base forward at 512^2 x 320, batch 2, 40 times: each output hashed
against the first. Then the same beside a process running bf16 8192^2
matmuls.

    python3 scripts/torch_determinism_probe.py    # on a machine with the card

Logs "probe det" lines; about 4 minutes with the build (ROADMAP queue 3,
S1).
"""
import hashlib
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

import torch  # noqa: E402

HOG = r"""
import time, torch
a = torch.randn(8192, 8192, device='cuda', dtype=torch.bfloat16)
t = time.time()
while time.time() - t < float(__import__('sys').argv[1]):
    for _ in range(20):
        b = a @ a
    torch.cuda.synchronize()
"""


def h(t):
    return hashlib.md5(t.detach().contiguous().view(torch.uint8)
                       .cpu().numpy().tobytes()).hexdigest()[:10]


def repeat(name, fn, n):
    ref = fn()
    refh = h(ref)
    bad, worst = 0, 0.0
    for _ in range(n):
        out = fn()
        if h(out) != refh:
            bad += 1
            worst = max(worst, float((out.float() - ref.float()).abs().max()))
    cs.log(f"probe det {name}: {bad} of {n} differ from the first "
           f"(worst max|d| {worst:.3e})")
    return bad


def main():
    cs.phase_device()
    cs.phase_build()
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel
    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = cs._attn_inputs(cs.MAIN_N, gen, dev)
    x, lnw, lnb, w1, b1, w2, b2 = cs._mlp_inputs(2 * cs.MAIN_N, gen, dev)
    cfg = VideoMAEConfig(image_size=512, num_frames=320, hidden_size=768,
                         num_hidden_layers=12, num_attention_heads=12,
                         intermediate_size=3072, dtype="bfloat16")
    model = VideoMAEModel(cfg).init_weights(
        torch.Generator().manual_seed(0)).to(dev).eval()
    px = torch.randn((2, 320, 1, 512, 512), generator=gen, device=dev)

    def fwd():
        with torch.inference_mode():
            return model(px)[0]

    def run(tag):
        bad = repeat(f"{tag} K1 N={cs.MAIN_N}",
                     lambda: A.flash_attention(q, k, v), 400)
        bad += repeat(f"{tag} K2 M={2 * cs.MAIN_N}",
                      lambda: M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2,
                                                eps=1e-12), 300)
        bad += repeat(f"{tag} forward batch 2", fwd, 40)
        return bad

    t0 = time.perf_counter()
    run("alone")
    cs.log(f"probe det: alone in {time.perf_counter() - t0:.1f} s")
    hog = subprocess.Popen([sys.executable, "-c", HOG, "100"])
    time.sleep(8)
    t0 = time.perf_counter()
    try:
        run("beside a matmul process")
    finally:
        hog.kill()
        hog.wait()
    cs.log(f"probe det: with the hog in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
