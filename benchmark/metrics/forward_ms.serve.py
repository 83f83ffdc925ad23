"""forward_ms.serve: mean over the window's requests of the serve callable's
time between CUDA events, from the end of the upload to the prediction on
the card."""


def read(record):
    if record.forward is None or record.trace is None or not record.trace.cuda:
        return None
    return record.forward.mean_ms()
