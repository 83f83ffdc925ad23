"""The cells at a size the CPU runs in seconds: every width as configured
but the latent grid (8 x 8 x 4), the processor's depth (2 blocks), the mesh
(4,096 nodes) and the radius, scaled to the coarser grid."""
TINY = {"nodes": 4096, "section_chunk": 512,
        "model": {"latent_tokens": [8, 8, 4],
                  "magno": {"gno_radius": 0.3, "slot_budget": 8, "edge_chunk_size": 512},
                  "transformer": {"num_layers": 2}},
        "dataset": {"train_size": 10}}
TRAFFIC = {"drivaernet-train": {"meshes": 4}, "drivaerml-serve": None}
SEED = 2 ** 31 + 12345
