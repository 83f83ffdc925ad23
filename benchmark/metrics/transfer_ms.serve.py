"""transfer_ms.serve: mean host ms of a request's copies to the card and back
(the benchmark's upload and download spans), over the window's requests."""


def read(record):
    if record.trace is None or not record.trace.cuda:
        return None
    return record.spans.mean_ms("upload", "download")
