"""The system under test: gaot3d_tpu_torch's model built from a
configuration file, its weights made from the seed on the run's device, and
the launch counters of its kernels."""
from __future__ import annotations

from typing import Dict

import torch

from .traffic import stream_seed


def build_model(cfg: dict, seed: int, device) -> torch.nn.Module:
    """The configuration's GAOT3D on `device`. Every Linear's weight and bias
    are uniform in +-1/sqrt(fan_in) (torch.nn.Linear's default), drawn as one
    block from a generator on the device; RMSNorm weights are 1."""
    from gaot3d_tpu_torch.models import (AttentionConfig, FFNConfig, MAGNOConfig,
                                         TransformerConfig)
    from gaot3d_tpu_torch.models.gaot3d import GAOT3D

    m = cfg["model"]
    tr = dict(m["transformer"])
    tr["attn_config"] = AttentionConfig(**tr["attn_config"])
    tr["ffn_config"] = FFNConfig(**tr["ffn_config"])
    model = GAOT3D(int(cfg["input_channels"]), int(cfg["output_channels"]),
                   MAGNOConfig(**m["magno"]), TransformerConfig(**tr),
                   latent_tokens=tuple(m["latent_tokens"])).to(device)
    linears = [mod for mod in model.modules() if isinstance(mod, torch.nn.Linear)]
    leaves = [(p, mod.weight.shape[1] ** -0.5) for mod in linears
              for p in (mod.weight, mod.bias) if p is not None]
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 2))
    draws = torch.rand(sum(p.numel() for p, _ in leaves), generator=g, device=device)
    with torch.no_grad():
        off = 0
        for p, bound in leaves:
            p.copy_((draws[off:off + p.numel()].view_as(p) * 2.0 - 1.0) * bound)
            off += p.numel()
    return model


def launches() -> Dict[str, int]:
    """Launches so far of the kernels the cells run: K1 (attention forward),
    K2 (its fused backward), K3 (the split backward's two kernels), K5 and
    K5b (encoder payload forward and backward) and their bf16 bodies."""
    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1

    return {"k1": k1.flash_attention.launches, "k2": k1.flash_attention_backward.launches,
            "k3": k1.flash_attention_backward_dkv.launches
            + k1.flash_attention_backward_dq.launches,
            "k5": k5.encoder_accumulate.launches, "k5_bf16": k5.encoder_accumulate.launches_bf16,
            "k5b": k5.encoder_accumulate_backward.launches,
            "k5b_bf16": k5.encoder_accumulate_backward.launches_bf16}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    now = launches()
    return {k: now[k] - before[k] for k in now}


class Capture:
    """The tensors of the model's last forward that the comparison reads
    (correctness.stage_gaps), held by reference with no copy: the encoder's
    GNO mean "gno" (the first half of what its recovery layer reads) and
    output "enc", the decoder's input "dec_in" and output "pred", each of
    the batch's one sample. `take()` hands them over and starts afresh."""

    def __init__(self, model: torch.nn.Module):
        self.last: Dict[str, torch.Tensor] = {}
        self.hooks = [
            model.encoder.register_forward_hook(lambda m, a, out: self._put(enc=out)),
            model.decoder.register_forward_hook(
                lambda m, a, out: self._put(dec_in=a[0], pred=out)),
            # the recovery layer reads cat[GNO mean, geoembed]
            model.encoder.recovery.register_forward_pre_hook(
                lambda m, a: self._put(gno=a[0].chunk(2, dim=-1)[0]))]

    def _put(self, **tensors: torch.Tensor) -> None:
        self.last.update({k: v.detach()[0] for k, v in tensors.items()})

    def take(self) -> Dict[str, torch.Tensor]:
        out, self.last = self.last, {}
        return out

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()
