"""The four-card cell's path on the CPU: four processes joined by gloo
(ratrack_tpu_torch.parallel.mesh.init_from_env(device="cpu")), each
running the harness on its shard of a tiny train_vod512_dp4 as rank r;
rank 0's result is correct, and comes out not correct with the exchange
between the ranks left out (the family's exchange_left_out)."""

import contextlib
import json
import time

import pytest
import torch.multiprocessing as mp

CELL = "train_vod512_dp4"
WORLD = 4


def _rank(rank, rdv, out, fault):
    import os
    import torch
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(WORLD))
    from perfbench import harness
    from perfbench.tests.tiny import SEED, tiny_cell
    from ratrack_tpu_torch.parallel import mesh as mesh_mod
    device = mesh_mod.init_from_env("cpu", init_method=f"file://{rdv}")
    mesh = mesh_mod.make_mesh()
    cell = tiny_cell(CELL)
    cell.traffic.update(streams=2 * WORLD)
    with (cell.family.exchange_left_out() if fault
          else contextlib.nullcontext()):
        res = harness.run_cell(cell, SEED, 1.0, False, device,
                               time.perf_counter(), mesh=mesh)
    torch.distributed.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def _run(tmp_path, fault):
    rdv, out = tmp_path / "rdv", tmp_path / "result.json"
    mp.start_processes(_rank, args=(str(rdv), str(out), fault),
                       nprocs=WORLD, join=True, start_method="spawn")
    with open(out) as f:
        return json.load(f)


def test_four_ranks_are_correct(tmp_path):
    res = _run(tmp_path, fault=False)
    assert res["correct"], res["check"]
    assert res["check"]["rank_gap"]["value"] == 0.0
    assert res["attempted"] % (2 * WORLD) == 0


@pytest.mark.parametrize("fault", ["exchange_left_out"])
def test_exchange_left_out_is_not_correct(tmp_path, fault):
    res = _run(tmp_path, fault=True)
    assert not res["correct"], res["check"]
