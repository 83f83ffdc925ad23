"""Convert a trained reference (PyTorch GAOT-3D) checkpoint into a checkpoint
of this framework (the port's twin of tools/import_torch_ckpt.py).

    python -m gaot3d_tpu_torch.tools.import_torch_ckpt --config run.toml \
        --torch-ckpt model.pt --output run.pt        # or run.msgpack

The run config supplies the architecture; the input and output widths are
read from the checkpoint. The mapping is `weights.state_dict_from_reference`
(strict: only the reference's dead `skip_proj` weights are dropped). A `.pt`
output is the port trainer's checkpoint layout `{"params": state_dict}`; a
`.msgpack` output is the JAX package's `{"params": variables}`, which its
trainer's `load_params_only` reads, as the JAX tool writes.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def _is_state_dict(d) -> bool:
    # a real module state dict is a non-empty {dotted.name: tensor} mapping;
    # the dotted-key requirement rejects look-alikes such as {'epoch': tensor}
    return (isinstance(d, dict) and len(d) > 0
            and all(hasattr(v, "shape") for v in d.values())
            and any("." in k for k in d))


def extract_state_dict(ckpt):
    """Reference checkpoints are `{name: module.state_dict()}` (its
    src/trainer/utils/setup.py:18-42): `model`, `gaot_3d` or `state_dict`,
    or a one-entry dict; a bare state dict is taken as it is."""
    if not isinstance(ckpt, dict) or not ckpt:
        raise ValueError(f"checkpoint is not a non-empty dict: {type(ckpt)}")
    if _is_state_dict(ckpt):
        return ckpt
    for key in ("model", "gaot_3d", "state_dict"):
        if key in ckpt and _is_state_dict(ckpt[key]):
            return ckpt[key]
    if len(ckpt) == 1:
        (inner,) = ckpt.values()
        if _is_state_dict(inner):
            return inner
    raise ValueError(f"cannot locate a state dict among keys {list(ckpt)}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--torch-ckpt", required=True)
    ap.add_argument("--output", required=True, help=".pt (port) or .msgpack (JAX) output")
    ap.add_argument("--device", default=None, help="JAX's conversion backend: ignored here")
    args = ap.parse_args(argv)

    import torch

    from ..config import load_run_config
    from ..models import init_model
    from ..train.checkpoint import save_checkpoint, save_msgpack_params
    from ..weights import (io_channels, load_numpy_state_dict, state_dict_from_reference,
                           strip_ddp_prefix)

    if args.device is not None:
        print("import_torch_ckpt: --device names JAX's backend and is ignored: the "
              "conversion runs on the CPU")
    cfg = load_run_config(args.config)
    margs = cfg.model.args
    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    sd = strip_ddp_prefix(extract_state_dict(ckpt))
    cin, cout = io_channels(sd)
    model = init_model(cin, cout, cfg.model.name, margs.magno, margs.transformer,
                       latent_tokens=tuple(margs.latent_tokens), device="cpu")
    load_numpy_state_dict(model, state_dict_from_reference(sd, model))
    if args.output.endswith(".msgpack"):
        save_msgpack_params(args.output, model)
    else:
        save_checkpoint(args.output, {"params": model.state_dict()})
    n = sum(p.numel() for p in model.parameters())
    print(f"imported {args.torch_ckpt} -> {args.output} ({n:,} params)")


if __name__ == "__main__":
    main()
