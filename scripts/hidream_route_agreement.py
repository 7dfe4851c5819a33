"""How often the served HiDream edit and its float32 reference route a token
differently: at the first denoise step of one request, where both sides
start from the same latents, condition and text, the share of (token,
expert layer) pairs whose two chosen experts differ, per layer and over
all 48.  Top-2 routing is discontinuous, so a near-tie between a token's
second and third expert can fall either way between bf16 W8A8 and
float32.

    python3 scripts/hidream_route_agreement.py [--seed N] [--image J]

Needs a CUDA card (the cell's full-width configuration); prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import registry, traffic  # noqa: E402
from perfbench.drivers import serve_edit_hidream  # noqa: E402
from perfbench.reference import brain, hidream, vae  # noqa: E402
from perfbench.reference.edit import image_ids  # noqa: E402

CELL = "hidream_edit_b4_512"


def program_routes(drv, unit: int, n_layers: int):
    """The program's (indices [M, k]) of each expert layer of the first
    step of request ``unit``."""
    from loongx_tpu_torch.ops import moe

    routes, route = [], moe.route

    def recording(x, w_gate, top_k):
        idx, wts = route(x, w_gate, top_k)
        if len(routes) < n_layers:
            routes.append(idx.cpu())
        return idx, wts

    moe.route = recording
    try:
        drv.run_unit(unit, keep=False)
    finally:
        moe.route = route
    return routes


def reference_routes(drv, unit: int, j: int):
    """The reference's (indices, weights) of each expert layer of the first
    step of image ``j`` of request ``unit``."""
    cfg, t, v = drv.cfg, drv.cfg["transformer"], drv.cfg["vae"]
    w = serve_edit_hidream.reference_weights(cfg, drv.seed, drv.device)
    x = traffic.draw(drv.mix, drv.sizes, drv.seed, unit, drv.device)
    x = {k: val[j:j + 1] for k, val in x.items()}
    image = x["image"].float() / 127.5 - 1.0
    prompt, pooled = brain.brain_embeds(w["brain"], x)
    pooled = torch.cat([pooled, x["pooled_extra"].float()], -1)
    mean, logvar = vae.encode(w["vae"], v, image)
    lat = mean + torch.exp(0.5 * logvar) * x["cond_noise"].float()
    cond = hidream.pack_patches((lat - v["shift_factor"]) * v["scaling_factor"],
                                t["patch_size"])
    ids = image_ids(lat.shape[1], lat.shape[2], drv.device)
    lin = hidream.Linears(drv.acts)
    routings = []
    hidream.hidream_forward(
        w["hidream"], t, lin, img=x["latents"].float(), cond=cond,
        text=hidream.project_text(w["hidream"], lin, prompt, x["llama"]),
        pooled=pooled, timestep=torch.ones(1, device=drv.device), img_ids=ids,
        cond_ids=ids, routings=routings)
    return [r[0].cpu() for r in routings]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=20260122)
    parser.add_argument("--image", type=int, default=0)
    args = parser.parse_args(argv)
    cell = registry.cell(registry.benchmark(), CELL)
    cfg = registry.config(cell["config_entry"])
    mix = registry.traffic(cell["traffic"])
    drv = serve_edit_hidream.Driver(cfg, mix, args.seed)
    t, s = cfg["transformer"], drv.sizes
    n_dbl, n_layers = t["num_layers"], t["num_layers"] + t["num_single_layers"]
    got = program_routes(drv, 0, n_layers)
    drv.free()
    torch.backends.cuda.matmul.allow_tf32 = False
    want = reference_routes(drv, 0, args.image)
    b, j = s["batch"], args.image
    n_lat = 2 * s["tokens"]
    n_txt = s["text_tokens"] + s["llama_tokens"]
    per_layer = []
    for layer, (p, r) in enumerate(zip(got, want)):
        rows = p.shape[0] // b
        p = p[j * rows:(j + 1) * rows]
        if layer >= n_dbl:  # the program's [L_i ; txt0 ; img ; cond]
            llama = s["llama_tokens"]
            head = llama + n_txt
            p = torch.cat([p[head:], p[llama:head], p[:llama]])
        assert p.shape == r.shape, (layer, p.shape, r.shape)
        differ = (p.sort(-1).values != r.sort(-1).values).any(-1)
        per_layer.append(float(differ.float().mean()))
    pairs = [(len(r)) for r in want]
    share = sum(x * n for x, n in zip(per_layer, pairs)) / sum(pairs)
    print(json.dumps({"seed": args.seed, "image": j, "layers": len(per_layer),
                      "tokens_double": n_lat, "share_differ": share,
                      "per_layer": per_layer}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
