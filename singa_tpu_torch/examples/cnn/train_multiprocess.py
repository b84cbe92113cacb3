"""Data-parallel CNN training on one host, one process a rank — the
counterpart of the JAX package's ``examples/cnn/train_multiprocess.py``.

    python -m singa_tpu_torch.examples.cnn.train_multiprocess cnn -w 2 \\
        [--dist-option plain|fp16|partial|sparse|sharded] [--device cpu]

``main`` starts ``-w`` ranks through
:func:`~singa_tpu_torch.parallel.launch` (0: every card of the host; one
rank with ``--device cpu``, whose ranks are gloo processes), and each
runs :func:`run`: the zoo model (``model`` argument) on synthetic data,
``DistOpt(SGD)`` (the learning rate of ``-l``, momentum 0.9, weight
decay 1e-5) over ``Communicator.from_devices()``, the captured step
(``use_graph=True``).  ``-b`` is the batch of one rank: every step
draws the global batch of ``-b`` times the world size from the epoch's
``np.random.permutation`` (seeded by ``-s``, the same on every rank) and
each rank's ``train_one_batch`` takes its rows.  Rank 0 prints the
reference's lines (``mesh: ...``, then ``epoch e: loss=... acc=...
... img/s global``: the group's mean loss and the accuracy of the
gathered logits) and returns the losses.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ... import opt
from ...device import get_device
from ...parallel import Communicator, launch
from ...tensor import Tensor
from .data import synthetic
from .train_cnn import _global_rows, accuracy, create_model


def run(args, states=None):
    """One rank's training, in a process of an initialised group
    (:func:`main` through ``launch``, or ``train_mpi``).  ``states``:
    the model's states by name to start from instead of the seeded
    weights (a JAX model's ``get_states()`` as numpy arrays crosses).
    Returns ``{"epoch_losses": [...], "step_losses": [...], "loss": the
    last epoch's, "accuracy": its accuracy}``."""
    comm = Communicator.from_devices()
    rank0 = comm.global_rank == 0
    if rank0:
        print(f"mesh: {comm.world_size} chips, data axis "
              f"'{comm.data_axis}'", flush=True)
    dev = get_device(comm.device)
    np.random.seed(args.seed)
    dev.set_rand_seed(args.seed)
    x, y = synthetic.load(args.data, num=args.num_samples, seed=args.seed)
    num_classes = int(y.max()) + 1
    model = create_model(args.model, num_classes=num_classes,
                         num_channels=x.shape[1])
    sgd = opt.SGD(lr=args.lr, momentum=0.9, weight_decay=1e-5)
    model.set_optimizer(opt.DistOpt(sgd, communicator=comm))
    bs = args.batch_size * comm.world_size          # the global batch
    model.compile([Tensor(data=x[:bs], device=dev, requires_grad=False)],
                  is_train=True, use_graph=True, communicator=comm)
    if states is not None:
        model.set_states(states)
    nb = len(x) // bs
    out = {"epoch_losses": [], "step_losses": []}
    for epoch in range(args.max_epoch):
        t0 = time.perf_counter()
        tot_loss, tot_acc = 0.0, 0.0
        idx = np.random.permutation(len(x))
        for b in range(nb):
            sel = idx[b * bs:(b + 1) * bs]
            pred, loss = model.train_one_batch(x[sel], y[sel],
                                               args.dist_option, args.spars)
            lv = float(loss.item())       # the group's mean
            out["step_losses"].append(lv)
            tot_loss += lv
            tot_acc += accuracy(_global_rows(comm, pred), y[sel])
        dt = time.perf_counter() - t0
        out["epoch_losses"].append(tot_loss / nb)
        out["loss"], out["accuracy"] = tot_loss / nb, tot_acc / nb
        if rank0:
            print(f"epoch {epoch}: loss={tot_loss / nb:.4f} "
                  f"acc={tot_acc / nb:.4f} {nb * bs / dt:.1f} img/s global",
                  flush=True)
    return out


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("model", nargs="?", default="cnn")
    p.add_argument("-d", "--data", default="mnist")
    p.add_argument("-m", "--max-epoch", type=int, default=3)
    p.add_argument("-b", "--batch-size", type=int, default=32,
                   help="the batch of one rank")
    p.add_argument("-l", "--lr", type=float, default=0.005)
    p.add_argument("-n", "--num-samples", type=int, default=1024)
    p.add_argument("-w", "--world-size", type=int, default=0,
                   help="ranks (0: every card of this host)")
    p.add_argument("--dist-option", default="plain",
                   choices=["plain", "fp16", "partial", "sparse", "sharded"])
    p.add_argument("--spars", type=float, default=0.05)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: a card a rank over NCCL; cpu: gloo ranks")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    world = args.world_size or (torch.cuda.device_count()
                                if args.device == "cuda" else 1)
    return launch(run, world, args=(args,), device=args.device)


if __name__ == "__main__":
    main()
