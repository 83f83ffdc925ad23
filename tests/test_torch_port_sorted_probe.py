"""The sorted-kernels probe (`gaot3d_tpu_torch/tools/probe_sorted_kernels.py`)
on the CPU: every source it builds (K6, K7, K8) is still a patch away from the
kernels in the checkout, each step of a kernel gets its stamp, and without a
card it refuses to run."""
import pytest
import torch

from gaot3d_tpu_torch.tools import probe_sorted_kernels as probe
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)


def test_every_patch_applies_to_the_sources():
    sources = probe.variant_sources()
    assert set(sources) == ({f"{k}_timeline" for k in probe.TIMELINES}
                            | {f"k8_setting_{i}" for i in range(len(probe.K8_SETTINGS))}
                            | {f"k6_setting_{i}" for i in range(len(probe.K6_SETTINGS))})
    assert set(probe.TIMELINES) == {"prefix_sum", "tile_segment_sum", "segment_sum_sorted"}
    for kernel, (_, _, _, steps) in probe.TIMELINES.items():
        src = sources[f"{kernel}_timeline"]
        for k in range(len(steps) + 1):  # a stamp where each step begins, one after the last
            assert src.count(f"TL({k});") == 1, (kernel, k)
        assert "gaot_set_timeline" in src
    for prefix, source, settings in (("k8", "tile_segment_sum.cu", probe.K8_SETTINGS),
                                     ("k6", "segment_sum_sorted.cu", probe.K6_SETTINGS)):
        shipped = probe.setting_source(source, {})
        assert sources[f"{prefix}_setting_0"] == shipped
        for i, constants in enumerate(settings.values()):
            if i and (constants[0] if prefix == "k6" else constants):
                assert sources[f"{prefix}_setting_{i}"] != shipped, (prefix, i)


def test_a_constant_the_kernel_lacks_raises():
    with pytest.raises(RuntimeError, match="no constant"):
        probe.setting_source("tile_segment_sum.cu", {"NO_SUCH_CONSTANT": 1})
    with pytest.raises(RuntimeError, match="no constant"):
        probe.setting_source("segment_sum_sorted.cu", {"SEG_TILE": 64})


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        probe.run()
