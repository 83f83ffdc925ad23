"""process_busy_ms.serve: device busy ms a traced request of the operations
launched inside the span gaot.process (patchify, the U-ViT processor,
unpatchify), by launch correlation (stages.py)."""
from benchmark import stages


def read(record):
    return stages.busy_ms(record, "gaot.process")
