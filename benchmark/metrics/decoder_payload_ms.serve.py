"""decoder_payload_ms.serve: device ms a traced request of K9, the kernel
that takes the MAGNO decoder's GNO mean over every node in one pass
(gaot3d_tpu_torch/csrc/decoder_payload.cu), by kernel name. None where no
such kernel ran (a program without it)."""


def read(record):
    tr = record.trace
    if tr is None or not tr.items:
        return None
    seconds, launches = tr.kernel_seconds("decoder_payload")
    if launches == 0:
        return None
    return 1e3 * seconds / tr.items
