"""Export a trained run's checkpoint as a serving artifact (the port's twin of
tools/export_model.py).

    python -m gaot3d_tpu_torch.tools.export_model --config run.toml \
        --ckpt run.pt --output model.pt --nodes 524288 [--edges baked]
    python -m gaot3d_tpu_torch.tools.export_model --config run.toml \
        --ckpt run.msgpack --output bundle.pt --nodes 262144,524288

Builds the model from the run config's `model.args` as written, as the JAX
tool does: the trainer's `setup.dtype: bfloat16` rule is not applied, so a
run trained with `setup.dtype: bfloat16` and `kernel_dtype: float32` exports
float32 kernel MLPs, and the latent grid is the default [-1, 1] box. Loads
the parameters of the port trainer's checkpoint or of a JAX `.msgpack`, and
writes `gaot3d_tpu_torch.serve.export_inference`'s artifact (one `--nodes`
value) or `export_inference_buckets`' bundle (a comma list), served by
`load_inference` / `load_inference_buckets`. The export runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="the port trainer's checkpoint, or a JAX .msgpack checkpoint")
    ap.add_argument("--output", required=True)
    ap.add_argument("--nodes", required=True,
                    help="node count(s) the artifact serves. One value writes a single "
                         "artifact (the port's forward serves any count); a comma list "
                         "(e.g. 262144,524288) writes a BUCKET BUNDLE whose dispatcher pads "
                         "each request to the smallest covering bucket")
    ap.add_argument("--batch", type=int, default=1,
                    help="batch of the requests, printed: the artifact serves any batch")
    ap.add_argument("--edges", default="baked",
                    help="'baked': the artifact builds its slots on the device in the "
                         "forward (serving mode 'device'); 'slots', 'flat', 'sectioned' or an "
                         "'enc,dec' pair: edge structures are call-time arguments (mode "
                         "'args', which takes any of them)")
    ap.add_argument("--in-channels", type=int, default=1)
    ap.add_argument("--out-channels", type=int, default=1)
    ap.add_argument("--platforms", nargs="*", default=None,
                    help="JAX's cross-lowering platforms: ignored here")
    ap.add_argument("--device", default=None, help="JAX's tracing backend: ignored here")
    args = ap.parse_args(argv)

    from ..config import load_run_config
    from ..edges import parse_edge_layout
    from ..models import init_model
    from ..serve import export_inference, export_inference_buckets
    from ..train.checkpoint import load_trained_params

    given = [f"--{name}" for name in ("platforms", "device") if getattr(args, name) is not None]
    if given:
        print(f"export_model: {' and '.join(given)} name JAX's lowering and tracing backends and "
              "are ignored: the artifact holds weights, not a compiled function")
    if args.edges == "baked":
        mode = "device"
    else:
        parse_edge_layout(args.edges.split(",") if "," in args.edges else args.edges)
        mode = "args"
    cfg = load_run_config(args.config)
    margs = cfg.model.args
    model = init_model(args.in_channels, args.out_channels, cfg.model.name, margs.magno,
                       margs.transformer, latent_tokens=tuple(margs.latent_tokens),
                       device="cpu")
    load_trained_params(args.ckpt, model)
    buckets = sorted(int(n) for n in str(args.nodes).split(","))
    if len(buckets) == 1:
        export_inference(model, args.output, edges=mode)
    else:
        export_inference_buckets(model, args.output, buckets, edges=mode)
    print(f"exported {args.output} ({os.path.getsize(args.output)} bytes), buckets {buckets}, "
          f"batch {args.batch}, {args.in_channels} -> {args.out_channels} channels, "
          f"edges {mode}")


if __name__ == "__main__":
    main()
