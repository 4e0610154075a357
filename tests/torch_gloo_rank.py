"""One rank of the two-rank gloo tests in ``test_torch_sharded.py`` and
``test_torch_async_sharded.py``.

A module of its own, importing only the port, so that a spawned rank
starts without JAX."""
import torch
import torch.distributed as dist

from repro_torch.federated import server, simulation


def run_rank(rank, world, init, queue, sel_args, sel_kw, fl_cfg):
    """The selection engine (``run_rounds_sharded(*sel_args, **sel_kw)``)
    and the trainer (``run_fl(fl_cfg, engine="sharded")``) on the
    process-group mesh, one shard a rank; the results go to ``queue``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        pop, _, traj = simulation.run_rounds_sharded(*sel_args, **sel_kw)
        hist = server.run_fl(fl_cfg, engine="sharded", device="cpu")
        queue.put((rank, traj, pop.battery_pct.numpy(), hist.as_dict()))
    finally:
        dist.destroy_process_group()


def run_async_rank(rank, world, init, queue, args, kw):
    """The async selection engine (``run_async_sharded(*args, **kw)``) on
    the process-group mesh, one shard a rank; the trajectory, the final
    batteries and event clocks go to ``queue``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        pop, _, traj = simulation.run_async_sharded(*args, **kw)
        t_done = traj.pop("final_event_state").t_done.numpy()
        queue.put((rank, traj, pop.battery_pct.numpy(), t_done))
    finally:
        dist.destroy_process_group()
