"""The port's data feed, all on the host: datasets and statistics (`dataset.py`),
transforms, native sample IO, edge building and layouts (`host_graph.py`), the
precompute sweep (`graph_precompute.py`) and batching with prefetch (`pipeline.py`)."""
