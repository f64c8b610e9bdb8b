"""The readings that a cell's limits are set from, and the faults and the
control its check must fail. Not run by the benchmark's runs.

    python3 portbench/controls.py --workload <cell> --mode <mode> --seeds a,b,c

`program`: the program's readings (a run with a one-step window).
`control`: the reference in the program's place, one precision down
(TF32 for the configuration's float32 with TF32 off), against the
reference in float32. `half_batch` (training): the reference leaving out
half of each image's rows, the mean over the rest. `altered` (serving):
the reference's image with one 16x16 block inverted. Prints one JSON line
per seed.
"""
import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def tf32(on: bool):
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference_readings(ctx: dict, mode: str) -> dict:
    """The control's or a fault's numbers, with the reference in the
    program's place, from the inputs a run of this seed makes."""
    import numpy as np
    import torch
    from harness import scene as S
    from harness import state as ST
    from kinds import serve, train
    from reference import render as R
    from reference.train import leaves, run_steps, serve_image
    cfg, conf, traffic, device = ctx["cfg"], ctx["conf"], ctx["traffic"], ctx["device"]
    n_img, sizes = conf["train_images"], conf["image_sizes"]
    if traffic["kind"] == "train":
        step0 = traffic["resume_iteration"]
        made = ST.make(ctx["seed"], cfg, conf["scene"], device, n_img, sizes, True, step0)
        canvas = ST.canvas(sizes)
        inp = ST.reference_inputs(made, cfg, device, canvas)
        order = train.camera_order(ctx["seed"], n_img, 1)[:traffic["check_steps"]]
        start = leaves(inp.state, inp.mlp, inp.head)

        def follow(**kw):
            losses, g1, final = run_steps(inp, cfg, order, step0 + 1, canvas, **kw)
            return losses, train.norms(g1), {k: float((final[k] - v).double().norm())
                                             for k, v in start.items()}
        ref = follow()
        if mode == "control":
            with tf32(True):
                other = follow()
        elif mode == "half_batch":
            other = follow(pixel_share=0.5)
        else:
            raise ValueError(f"no {mode!r} reading for a training cell")
        return train.compare(*other, *ref)
    made = ST.make(ctx["seed"], cfg, conf["scene"], device, n_img, sizes, False, 0, training=False)
    w, h = traffic["width"], traffic["height"]
    inp = ST.reference_inputs(made, cfg, device, (w, h))
    filt = torch.from_numpy(np.asarray(made.flat["aux/filter_3D"])).to(device)[inp.slots]
    poses = S.view_poses(traffic["poses"], w, h, device)
    emb = np.asarray(made.flat["params/appearance_embeddings"])
    rng = np.random.default_rng(ctx["seed"] % (1 << 63))
    got, want = [], []
    for _ in range(traffic["sample"]):
        p = poses[int(rng.integers(0, len(poses)))]
        cam = R.camera(p.pose, p.intr, ST.canvas([(w, h)]), (w, h))
        e = torch.from_numpy(emb[int(rng.integers(0, n_img))]).to(device)
        ref = serve_image(inp, cfg, cam, e, filt).cpu().numpy()
        if mode == "control":
            with tf32(True):
                other = serve_image(inp, cfg, cam, e, filt).cpu().numpy()
        elif mode == "altered":
            other = ref.copy()
            other[:16, :16] = 1.0 - other[:16, :16]
        else:
            raise ValueError(f"no {mode!r} reading for a serving cell")
        got.append(other)
        want.append(ref)
    return serve.compare(got, want)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("program", "control", "half_batch", "altered"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.path.dirname(HERE))
    import importlib

    import torch
    import run
    if not torch.cuda.is_available():
        run.fail("the readings are taken on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    bench = run.load(os.path.dirname(HERE), "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = run.cell_context(args.workload, bench)
        ctx.update(seed=seed, seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                   t_start=time.perf_counter())
        if args.mode == "program":
            kind = importlib.import_module("kinds." + ctx["traffic"]["kind"])
            out, checks = kind.run(ctx)
            numbers = {k: c["value"] for k, c in checks.items()}
            numbers["problems"] = out["problems"]
        else:
            numbers = reference_readings(ctx, args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "seconds": time.perf_counter() - ctx["t_start"], **numbers}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
