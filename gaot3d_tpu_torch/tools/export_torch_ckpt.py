"""Convert a checkpoint of this framework into a reference (PyTorch GAOT-3D)
checkpoint: the inverse of import_torch_ckpt (the port's twin of
tools/export_torch_ckpt.py).

    python -m gaot3d_tpu_torch.tools.export_torch_ckpt --config run.toml \
        --ckpt run.pt --output model.pt          # or --ckpt run.msgpack

Reads the port trainer's checkpoint or a JAX `.msgpack`; the run config
supplies the architecture, the checkpoint the input and output widths.
Writes `{"model": state_dict}`, the reference's own save layout, with its
keys and its `latent_tokens` buffer (`weights.reference_state_dict`), as the
JAX tool writes it. With `use_long_range_skip: false` the reference builds
`skip_proj` weights the model does not have: load those configs into the
reference with `strict=False`.
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
    ap.add_argument("--output", required=True, help=".pt output path")
    ap.add_argument("--device", default=None, help="JAX's conversion backend: ignored here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..config import load_run_config
    from ..models import init_model
    from ..train.checkpoint import checkpoint_channels, load_trained_params
    from ..weights import reference_state_dict

    if args.device is not None:
        print("export_torch_ckpt: --device names JAX's backend and is ignored: the "
              "conversion runs on the CPU")
    cfg = load_run_config(args.config)
    margs = cfg.model.args
    cin, cout = checkpoint_channels(args.ckpt)
    model = init_model(cin, cout, cfg.model.name, margs.magno, margs.transformer,
                       latent_tokens=tuple(margs.latent_tokens), device="cpu")
    load_trained_params(args.ckpt, model)
    tsd = {k: torch.as_tensor(np.ascontiguousarray(v))
           for k, v in reference_state_dict(model).items()}
    tmp = args.output + ".tmp"
    torch.save({"model": tsd}, tmp)
    os.replace(tmp, args.output)
    n = sum(int(v.numel()) for v in tsd.values())
    print(f"exported {args.ckpt} -> {args.output} ({n:,} params, {len(tsd)} tensors)")


if __name__ == "__main__":
    main()
