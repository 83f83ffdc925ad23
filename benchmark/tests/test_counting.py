"""The counting functions against counts made by hand for one tiny mesh."""
import json
import os

import pytest
import torch

from benchmark import counting, harness
from benchmark.reference import graph as refgraph
from benchmark.reference import model as ref


def config(name):
    with open(os.path.join(harness.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_mlp_flops():
    assert counting.mlp_flops([6, 64, 64, 64, 32]) == 2 * (6 * 64 + 64 * 64 * 2 + 64 * 32)


def test_forward_flops_by_hand():
    cfg = config("drivaernet-pressure")
    N, E = 10, 7
    enc_edge = 2 * (6 * 64 + 64 * 64 + 64 * 64 + 64 * 32)   # 21,248
    dec_edge = 2 * (6 * 64 + 64 * 64 + 64 * 32)             # 13,056
    M, S, Hd = 64 * 64 * 32, 16384, 256
    by_hand = (N * 2 * 3 * 32 + E * enc_edge + M * 2 * (9 * 64 + 64 * 32) + M * 2 * 64 * 32
               + S * 2 * 256 * 256
               + 10 * (S * 2 * (4 * Hd * Hd + 3 * Hd * 1024) + 4 * S * S * Hd)
               + 5 * S * 2 * 512 * 256
               + E * dec_edge + N * 2 * (32 * 256 + 256 * 1))
    assert counting.forward_flops(cfg, N, E) == by_hand
    assert counting.train_step_flops(cfg, N, E) == 3 * by_hand


def test_attention_and_payload_by_hand():
    cfg = config("drivaernet-pressure")
    flops, nbytes = counting.attention_train(cfg)
    assert flops == 80 * 6 * 2 * 16384 * 16384 * 32   # 8.25e12
    assert nbytes == 80 * (8 * 16384 * 32 * 2 + 16384 * 4)
    f, b, rate = counting.payload(cfg, 100, 40)
    assert f == 40 * 21248 and rate == 989e12
    assert b == 100 * 35 * 4 + 40 * 5 + 131072 * 43 * 4
    assert counting.payload(config("drivaerml-pressure"), 100, 40)[2] == 495e12
    assert counting.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert counting.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)


def test_valid_edges_by_hand():
    """Two points on a 3 x 3 x 3 grid over [-1, 1] (spacing 1), radius 0.6:
    (0, 0, 0) sits on the centre cell alone; (0.5, 0, 0) is 0.5 from the
    centre and from (1, 0, 0), and no nearer cell: 1 + 2 edges."""
    grid = refgraph.Grid((3, 3, 3))
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]])
    cells, valid = refgraph.joined_cells(pos, grid, 0.6, 5)
    assert ref.valid_edges(valid) == 3
    assert cells[0, 0] == 13 and valid[0].tolist() == [True, False, False, False, False]
    assert cells[1, :2].tolist() == [13, 22]


def test_undecided_by_hand():
    """On the same grid: (0.6, 0, 0) lies at the radius of the centre cell;
    (0.3, 0, 0) is 0.3 and 0.7 from its cells; (0.5, 0.5, 0.5), at radius
    0.6, has no cell within it and its two nearest (all eight) tie."""
    grid = refgraph.Grid((3, 3, 3))
    pos = torch.tensor([[0.6, 0.0, 0.0], [0.3, 0.0, 0.0], [0.5, 0.5, 0.5]])
    nodes, cells = refgraph.undecided(pos, grid, 0.6)
    assert nodes.tolist() == [True, False, True]
    assert cells[13] and int(cells.sum()) == 1 + 2  # the centre, and two of the tied eight


def test_over_budget_by_hand():
    """On the same grid at radius 1.01: (0, 0, 0) is within the radius of
    the centre cell and its six neighbours, 7 cells; (0.5, 0.5, 0.5) of
    eight cells at 0.87; (0.5, 0, 0) of the centre and (1, 0, 0), 2 cells;
    a budget of 7 drops the edges of one point."""
    grid = refgraph.Grid((3, 3, 3))
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, 0.0, 0.0]])
    assert refgraph.over_budget(pos, grid, 1.01, 7) == 1
    assert refgraph.over_budget(pos, grid, 1.01, 6) == 2
    assert refgraph.over_budget(pos, grid, 1.01, 8) == 0
    assert refgraph.over_budget(pos, grid, 0.1, 1) == 0  # the nearest cell alone


def test_no_point_of_the_configurations_exceeds_its_budget():
    """At the configurations' radius and grid a point is joined to at most
    5 cells: a cell and its four neighbours in one plane (spacing 2/63 in
    x and y, under the radius; 2/31 in z and the diagonals, over it)."""
    for name in ("drivaernet-pressure", "drivaerml-pressure"):
        spec = ref.Spec.from_config(config(name))
        h = spec.grid.spacing
        on_cell = torch.tensor([[-1.0 + 31 * h[0], -1.0 + 31 * h[1], -1.0 + 15 * h[2]]])
        assert refgraph.over_budget(on_cell, spec.grid, spec.radius, 4) == 1
        assert refgraph.over_budget(on_cell, spec.grid, spec.radius, 5) == 0
        pts = torch.rand(20000, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
        assert refgraph.over_budget(torch.cat([pts, on_cell]), spec.grid, spec.radius, 5) == 0
