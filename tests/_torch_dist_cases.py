"""Rank bodies of the port's distributed tests (``test_torch_dist*.py``).

``singa_tpu_torch.parallel.launch`` pickles these functions by import
path into spawned ranks, so this module imports the port only: no jax,
no ``singa_tpu``.  Each body runs every case of its module in one
process group and returns rank 0's results (numpy arrays and floats);
what other ranks hold comes back all-gathered where a test needs it.
"""

import numpy as np
import torch

from singa_tpu_torch import autograd, layer, opt, precision
from singa_tpu_torch.model import Model
from singa_tpu_torch.parallel import Communicator
from singa_tpu_torch.tensor import Tensor

torch.set_num_threads(1)

LR, MOMENTUM = 0.1, 0.9


class MLP(Model):
    """``tests/test_dist.py``'s MLP (8 -> 32 -> relu -> 4), its step
    taking the update a case names."""

    def __init__(self, case):
        super().__init__()
        self.fc1 = layer.Linear(32)
        self.relu = layer.ReLU()
        self.fc2 = layer.Linear(4)
        self.case = case

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y, update=True, k=1):
        out = self.forward(x)
        loss = autograd.softmax_cross_entropy(out, y)
        dist_update(self.optimizer, loss, self.case, update, k)
        return out, loss


def dist_update(o, loss, case, update=True, k=1):
    """The DistOpt call a case names (the JAX side calls the same)."""
    v = case["variant"]
    thr = case.get("threshold", 50000)
    if v == "plain":
        o.backward_and_update(loss, threshold=thr)
    elif v == "half":
        o.backward_and_update_half(loss)
    elif v == "partial":
        o.backward_and_partial_update(loss, num_sync=2)
    elif v == "sparse":
        o.backward_and_sparse_update(loss, spars=0.3,
                                     encoding=case.get("encoding", "dense"))
    elif v == "sharded":
        o.backward_and_sharded_update(loss, threshold=thr)
    elif v == "accum":
        if update:
            o.backward_and_accum_update(loss, k)
        else:
            o.backward_and_accumulate(loss)
    else:
        raise ValueError(v)


def _np(t):
    """A host copy (a CPU tensor's buffer changes with the next step)."""
    return t.detach().cpu().numpy().copy()


def build(case, comm, x, init):
    """The port MLP under DistOpt(SGD 0.1, momentum 0.9) over ``comm``,
    compiled on the global batch ``x`` with ``use_graph=True``, from the
    states ``init``."""
    m = MLP(case)
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=LR, momentum=MOMENTUM),
                                communicator=comm))
    m.compile([Tensor(data=x, device="cpu", requires_grad=False)],
              is_train=True, use_graph=True, communicator=comm,
              precision=(precision.with_update_guard(case["precision"])
                         if case.get("precision") else None))
    m.set_states(init)
    return m


def states(m) -> dict:
    """The model's and (under ``opt.``) the optimizer's states: the
    optimizer's are a collective (ZeRO-1 state is all-gathered)."""
    out = {k: _np(t.data) for k, t in m.get_states().items()}
    out.update({f"opt.{k}": np.asarray(v)
                for k, v in m.optimizer.get_states().items()})
    return out


def train(m, batches):
    losses = []
    for args in batches:
        _, loss = m.train_one_batch(*args)
        losses.append(loss.item())
    return losses


def batches_for(case, x, y, steps):
    """A step's arguments: the global batch, or for ``accum`` its two
    micro-batches (accumulate, then update with k 2)."""
    if case["variant"] != "accum":
        return [(x, y)] * steps
    h = len(x) // 2
    return [(x[:h], y[:h], False, 2), (x[h:], y[h:], True, 2)] * steps


def gathered(comm, value) -> list:
    """``value`` (a float) of every rank, on rank 0."""
    return _np(comm.all_gather(torch.tensor([float(value)]))).tolist()


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def collectives():
    """Every collective on rank-dependent inputs; rank 0 returns what each
    rank got (all-gathered) and the communicator's counts."""
    comm = Communicator.from_devices()
    r, n = comm.global_rank, comm.world_size
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
    got = {
        "all_reduce": comm.all_reduce(x),
        "all_reduce_bf16": comm.all_reduce(x.to(torch.bfloat16)).float(),
        "all_reduce_mean": comm.all_reduce_mean(x),
        "all_gather": comm.all_gather(x),
        "all_gather_untiled": comm.all_gather(x, tiled=False),
        "all_gather_scalar": comm.all_gather(torch.tensor(float(r)),
                                             tiled=False),
        "reduce_scatter": comm.reduce_scatter(
            torch.arange(4 * n, dtype=torch.float32).reshape(2 * n, 2)
            * (r + 1)),
        "ppermute_ring": comm.ppermute(x, [(i, (i + 1) % n)
                                           for i in range(n)]),
        "ppermute_one": comm.ppermute(x, [(0, n - 1)]),
        "axis_index": torch.tensor(float(comm.axis_index())),
    }
    comm.wait()
    comm.barrier()
    stats = comm.comm_stats()
    out = {k: _np(comm.all_gather(v.contiguous(), tiled=False))
           for k, v in got.items()}
    out["stats"] = stats
    out["world_size"] = comm.world_size
    out["active"] = comm.active
    return out


def mlp_cases(cases, x, y, init, steps, ckpt_dir):
    """Every DistOpt case of ``test_torch_dist.py``'s world-2 group."""
    comm = Communicator.from_devices()
    out = {}
    for name, case in cases.items():
        m = build(case, comm, x, init)
        run = batches_for(case, x, y, steps)
        per_step = len(run) // steps
        losses = train(m, run[:per_step])
        first = states(m)
        losses += train(m, run[per_step:])
        out[name] = {"losses": losses, "first": first, "states": states(m),
                     "comm_stats": m.optimizer.comm_stats()}
    out["checkpoints"] = checkpoint_cases(comm, x, y, init, ckpt_dir)
    out["refusals"] = refusals(comm, x, y, init, ckpt_dir)
    out["overflow"] = {r: overflow_case(comm, x, y, init, r)
                       for r in range(comm.world_size)}
    return out


def checkpoint_cases(comm, x, y, init, ckpt_dir):
    """A port save at step 3 (every rank saves, rank 0 writes) and the
    port's own next step; the JAX save (``jax_sharded.zip``) loaded into
    a fresh model and stepped once."""
    case = {"variant": "sharded"}
    m = build(case, comm, x, init)
    train(m, [(x, y)] * 3)
    m.save_states(f"{ckpt_dir}/port_sharded.zip")
    after_save = train(m, [(x, y)])
    res = {"port_next_loss": after_save[0], "port_next": states(m)}
    fresh = build(case, comm, x, init)
    fresh.load_states(f"{ckpt_dir}/jax_sharded.zip")
    res["jax_loaded_loss"] = train(fresh, [(x, y)])[0]
    res["jax_loaded"] = states(fresh)
    return res


def refusals(comm, x, y, init, ckpt_dir):
    """The messages of the ZeRO-1 refusals a group can show: a restore
    of another world size once the shard views exist, and a step whose
    threshold differs from the checkpoint's."""
    out = {}
    m = build({"variant": "sharded"}, comm, x, init)
    train(m, [(x, y)])
    st = m.optimizer.get_states()
    st["__zero1_layout__"] = np.array([4, 50000], np.int64)
    try:
        m.optimizer.set_states(st)
    except ValueError as e:
        out["warm"] = str(e)
    small = build({"variant": "sharded", "threshold": 0}, comm, x, init)
    train(small, [(x, y)])
    small.save_states(f"{ckpt_dir}/port_threshold0.zip")
    m2 = build({"variant": "sharded"}, comm, x, init)
    m2.load_states(f"{ckpt_dir}/port_threshold0.zip")
    try:
        train(m2, [(x, y)])
    except ValueError as e:
        out["threshold"] = str(e)
    return out


def overflow_case(comm, x, y, init, rank):
    """Plain DistOpt under bf16 with a unit update guard: one clean step,
    then one whose batch holds an inf in ``rank``'s rows only.  Returns
    the states after each step and, for every rank, whether its states
    stayed bit-equal through the second step."""
    case = {"variant": "plain", "precision": "bfloat16"}
    m = build(case, comm, x, init)
    train(m, [(x, y)])
    first = states(m)
    mine = {k: _np(t.data).copy() for k, t in m.get_states().items()}
    mine.update({t.name: _np(t.data).copy()
                 for t in m.optimizer.state_tensors()})
    xb = x.copy()
    xb[rank * (len(x) // comm.world_size)] = np.inf
    loss = train(m, [(xb, y)])[0]
    now = {k: _np(t.data) for k, t in m.get_states().items()}
    now.update({t.name: _np(t.data) for t in m.optimizer.state_tensors()})
    kept = all(np.array_equal(mine[k], now[k]) for k in mine
               if not k.startswith(("loss_scale", "opt_step")))
    return {"first": first, "second": states(m), "loss": loss,
            "kept": gathered(comm, kept)}


def reshard_case(case, x, y, path, steps):
    """A fresh model of this group (world 4) restoring the world-2 JAX
    checkpoint at ``path`` (a cold cross-world-size reshard), then
    ``steps`` steps."""
    comm = Communicator.from_devices()
    m = build(case, comm, x, {})
    m.load_states(path)
    resaved = m.optimizer.get_states()      # before any step: pending
    losses = train(m, [(x, y)] * steps)
    return {"losses": losses, "states": states(m),
            "resaved_layout": resaved.get("__zero1_layout__")}


def fail_on_rank_1():
    """Rank 1 raises; rank 0 returns."""
    if Communicator.from_devices().global_rank == 1:
        raise ValueError("planted")
    return "rank 0"


def sharded_shapes(x, y):
    """The ZeRO-1 views' sizes and the momentum's shape on this rank, and
    their saved (global padded) shape and stamp, after one step."""
    comm = Communicator.from_devices()
    m = build({"variant": "sharded"}, comm, x, {})
    train(m, [(x, y)])
    st = {t.name: tuple(t.shape) for t in m.optimizer.state_tensors()}
    saved = m.optimizer.get_states()
    return {"views": {v.name: v.data.numel()
                      for v in m.optimizer._shard_views.values()},
            "mom:zero_bucket@zshard": st["mom:zero_bucket@zshard"],
            "saved": saved["mom:zero_bucket@zshard"].shape,
            "layout": saved["__zero1_layout__"].tolist()}


def zoo_cases(specs, batches, inits, lr):
    """The zoo's models through ``train_one_batch(x, y, dist_option)``
    under DistOpt(SGD, train_cnn.py's momentum and weight decay): for
    each ``key: (model, channels, dist_option)``, the losses and every
    state after the batches of its model."""
    from singa_tpu_torch.examples.cnn import train_cnn
    comm = Communicator.from_devices()
    out = {}
    for key, (name, c, option) in specs.items():
        m = train_cnn.create_model(name, num_classes=10, num_channels=c)
        m.set_optimizer(opt.DistOpt(
            opt.SGD(lr=lr, momentum=0.9, weight_decay=1e-5),
            communicator=comm))
        m.compile([Tensor(data=batches[name][0][0], device="cpu",
                          requires_grad=False)],
                  is_train=True, use_graph=True, communicator=comm)
        m.set_states(inits[name])
        losses = [m.train_one_batch(x, y, option)[1].item()
                  for x, y in batches[name]]
        out[key] = {"losses": losses, "states": states(m)}
    return out
