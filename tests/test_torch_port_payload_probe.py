"""The encoder payload probe (`gaot3d_tpu_torch/tools/probe_encoder_payload.py`)
on the CPU: every variant it builds, of the f32 and the bf16 bodies, is still
a few substitutions away from the kernels in the checkout, and without a card
it refuses to run."""
import pytest
import torch

from gaot3d_tpu_torch.tools import probe_encoder_payload as probe
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)


def test_every_variant_applies_to_the_sources():
    sources = probe.variant_sources()
    assert set(sources) == set(probe.VARIANTS)
    shipped = {kind: sources[name] for name, (kind, _, _, what) in probe.VARIANTS.items()
               if what == "as shipped"}
    assert set(shipped) == {"fwd", "bwd", "fwd_bf16", "bwd_bf16"}
    for name, (kind, _, _, what) in probe.VARIANTS.items():
        if what == "as shipped":
            continue
        assert sources[name] != shipped[kind], f"{name} changes nothing"
    for kind in shipped:  # only the recipe's instantiation is built
        src = shipped[kind][0]
        assert src.count("X(64, 32") == 1


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the refusal without a card")
def test_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        probe.run()
