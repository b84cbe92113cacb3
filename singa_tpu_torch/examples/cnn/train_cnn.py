"""Single-card CNN training on the port — the counterpart of the JAX
package's ``examples/cnn/train_cnn.py`` (its plain path, ``run``).

    python -m singa_tpu_torch.examples.cnn.train_cnn cnn -d mnist -m 5 \\
        [--device cuda|cpu]

The flags are the JAX example's; ``--device`` is ``cuda`` (the default)
or ``cpu``.  The model (the zoo of :mod:`.model`) trains with SGD (the
learning rate of ``-l``, momentum 0.9, weight decay 1e-5) through
``Model.compile(use_graph=...)``: on the card the step is a captured
CUDA graph (``-g`` turns it off).  Each epoch visits the samples in the
order of ``RandomState(seed + epoch).permutation``, as the reference's,
and logs its mean loss, accuracy and images/s.  ``--ckpt PATH`` saves
the zip checkpoint (the reference's format, readable by the JAX
package) after every epoch with the epoch in its aux states;
``--resume`` restores it and goes on at the next epoch.  ``-v 1`` times
every step and banks the step's flop table, ``-v 2`` also writes a
``torch.profiler`` trace into ``./profile_traces``
(``Device.SetVerbosity``, after ``compile``, as the reference's :171);
the table prints at the end (``Device.PrintTimeProfiling``, :210-211).

``--zero1 N`` trains with ZeRO-1 over N ranks, one process a rank
(:func:`~singa_tpu_torch.parallel.launch`; N cards, or gloo ranks with
``--device cpu``): ``DistOpt(SGD)``, every step the ``"sharded"``
update (the reference's flag, train_cnn.py:87), ``-b`` the global batch,
which each rank's ``train_one_batch`` splits; the reference's
single-process path (:140-165) takes the plain ``DistOpt`` update there,
the same values up to float order.  Rank 0 logs and returns; every rank
joins ``--ckpt``'s save and load.  ``--ckpt-format snapshot`` saves the
BinFile format instead of the zip.

The resilient mode (``--ckpt DIR --ckpt-every N``, the reference's
``run_resilient``, :77-129 and :173-176) trains step by step through
:mod:`singa_tpu_torch.resilience`: async atomic checkpoints every N
steps into the directory (``--ckpt-keep`` of them, ``--ckpt-sync`` to
write on the training thread), a cursor-carrying
:class:`~singa_tpu_torch.data.DataLoader` (the same batches as the plain
path's), the non-finite watchdog (``--watchdog skip|rollback|raise``),
shard-aware saves under ``--zero1``, and deterministic chaos
(``--chaos-nan-step``, ``--chaos-kill-step``, ``--chaos-kill-save`` at
``--chaos-kill-phase``) for kill-and-resume drills.  ``--resume``
restores the newest valid checkpoint (one the JAX package wrote too)
and replays the exact batch order, so the per-step losses
(``--log-steps``) equal an uninterrupted run's.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ... import opt, tensor
from ...data import ArrayDataset, DataLoader
from ...device import get_device
from ...logging import INFO, InitLogging, LOG
from ...parallel import Communicator, launch
from .data import loader


def create_model(name, **kw):
    if name == "cnn":
        from .model import cnn as m
    elif name == "alexnet":
        from .model import alexnet as m
    elif name == "xceptionnet":
        from .model import xceptionnet as m
    elif name == "mobilenet":
        from .model import mobilenet as m
    elif name.startswith("vgg"):
        from .model import vgg as m
        return m.create_model(name, **kw)
    else:
        from .model import resnet as m
        return m.create_model(name, **kw)
    return m.create_model(**kw)


def accuracy(pred, y):
    return float(np.mean(np.argmax(pred, axis=1) == y))


def _global_rows(comm, pred) -> np.ndarray:
    """A step's logits for the whole batch: the rank's rows gathered
    from every rank under a communicator."""
    data = pred.data if comm is None else comm.all_gather(pred.data)
    return data.detach().cpu().numpy()


def _quiet(*args):
    """The log of a rank other than 0: nothing."""


def build_fault_plan(args):
    """The chaos flags as a TrainFaultPlan (None when none is set)."""
    from ...resilience import (CrashAtStep, KillMidCheckpointWrite,
                               NaNGrads, TrainFaultPlan)
    faults = []
    if args.chaos_nan_step is not None:
        faults.append(NaNGrads(args.chaos_nan_step))
    if args.chaos_kill_step is not None:
        faults.append(CrashAtStep(args.chaos_kill_step))
    if args.chaos_kill_save:
        faults.append(KillMidCheckpointWrite(args.chaos_kill_save,
                                             phase=args.chaos_kill_phase))
    return TrainFaultPlan(*faults) if faults else None


def run(args):
    """Train as the flags say; returns ``{"loss": the last epoch's mean
    loss, "accuracy": its accuracy, "epoch_losses": [...],
    "step_losses": [...]}`` (rank 0's under ``--zero1``); the resilient
    mode adds ``"steps"``, the ``(step index, loss)`` of every step this
    run took."""
    if args.ckpt_every and not args.ckpt:
        raise SystemExit("--ckpt-every needs --ckpt DIR")
    if args.zero1:
        return launch(_run, args.zero1, args=(args,), device=args.device)
    return _run(args)


def _run(args):
    """The training loop, in the process of one rank under ``--zero1``
    (the process group is up)."""
    InitLogging("train_cnn")
    comm = None
    if args.zero1:
        comm = Communicator.from_devices()
        if comm.global_rank == 0:
            LOG(INFO, "ZeRO-1 group: %d ranks, axis %r", comm.world_size,
                comm.data_axis)
    log = LOG if comm is None or comm.global_rank == 0 else _quiet
    dev = get_device(args.device if comm is None else comm.device)
    np.random.seed(args.seed)
    dev.set_rand_seed(args.seed)

    x, y, source = loader.load(args.data, num=args.num_samples,
                               seed=args.seed, data_dir=args.data_dir)
    log(INFO, f"dataset {args.data}: {len(x)} samples from {source}")
    num_classes = int(y.max()) + 1
    model = create_model(args.model, num_classes=num_classes,
                         num_channels=x.shape[1])
    sgd = opt.SGD(lr=args.lr, momentum=0.9, weight_decay=1e-5)
    model.set_optimizer(opt.DistOpt(sgd, communicator=comm)
                        if comm is not None else sgd)
    extra = ("sharded",) if comm is not None else ()

    bs = args.batch_size
    tx = tensor.Tensor(data=x[:bs], device=dev)
    model.compile([tx], is_train=True, use_graph=args.graph,
                  sequential=False, communicator=comm)
    dev.SetVerbosity(args.verbosity)
    if args.ckpt_every:
        return run_resilient(args, model, x, y, comm, log)

    start_epoch = 0
    ckpt_exists = args.ckpt and (os.path.exists(args.ckpt)
                                 or os.path.exists(args.ckpt + ".bin"))
    if ckpt_exists and args.resume:
        # resume: params + optimizer state + epoch counter, no priming step
        aux = model.load_states(args.ckpt)
        start_epoch = int(aux.get("epoch", -1)) + 1
        log(INFO, "resumed from %s at epoch %d", args.ckpt, start_epoch)

    nb = len(x) // bs
    out = {"loss": float("nan"), "accuracy": float("nan"),
           "epoch_losses": [], "step_losses": []}
    for epoch in range(start_epoch, args.max_epoch):
        t0 = time.perf_counter()
        tot_loss, tot_acc = 0.0, 0.0
        idx = np.random.RandomState(args.seed + epoch).permutation(len(x))
        for b in range(nb):
            sel = idx[b * bs:(b + 1) * bs]
            pred, loss = model.train_one_batch(x[sel], y[sel], *extra)
            lv = float(loss.item())
            if args.log_steps:
                log(INFO, "step %d: loss=%r", epoch * nb + b, lv)
            out["step_losses"].append(lv)
            tot_loss += lv
            tot_acc += accuracy(_global_rows(comm, pred), y[sel])
        dt = time.perf_counter() - t0
        log(INFO, "epoch %d: loss=%.4f acc=%.4f %.1f img/s", epoch,
            tot_loss / nb, tot_acc / nb, nb * bs / dt)
        out["epoch_losses"].append(tot_loss / nb)
        out["loss"], out["accuracy"] = tot_loss / nb, tot_acc / nb
        if args.ckpt:
            model.save_states(args.ckpt,
                              aux_states={"epoch": np.asarray(epoch)},
                              format=args.ckpt_format)
    if args.verbosity:
        dev.PrintTimeProfiling()
    return out


def run_resilient(args, model, x, y, comm, log):
    """Step-granular training through :mod:`singa_tpu_torch.resilience`
    (the reference's ``run_resilient``): checkpoints every
    ``--ckpt-every`` steps into the ``--ckpt`` directory, the loader
    cursor and the generator state in its manifest, the watchdog on the
    loss the host reads."""
    from ...resilience import CheckpointManager, ResilientTrainer

    bs = args.batch_size
    extra = ("sharded",) if comm is not None else ()
    dl = DataLoader(ArrayDataset(x, y), bs, seed=args.seed, prefetch=2)
    faults = build_fault_plan(args)
    ck = CheckpointManager(model, args.ckpt, keep=args.ckpt_keep,
                           fmt=args.ckpt_format,
                           async_save=False if args.ckpt_sync else None,
                           shard_aware=comm is not None, faults=faults)
    trainer = ResilientTrainer(model, checkpoint=ck, loader=dl,
                               save_every=args.ckpt_every,
                               nonfinite_policy=args.watchdog,
                               faults=faults)
    if args.resume:
        meta = trainer.resume()
        if meta is not None:
            log(INFO, "resumed from %s at step %d (epoch %d, batch %d)",
                args.ckpt, trainer.step_index, dl.epoch,
                dl.state_dict()["pos"])

    out = {"loss": float("nan"), "accuracy": float("nan"),
           "epoch_losses": [], "step_losses": [], "steps": []}
    with ck:
        while dl.epoch < args.max_epoch:
            epoch = dl.epoch
            t0 = time.perf_counter()
            tot_loss, tot_acc, nbatch, rolled = 0.0, 0.0, 0, False
            for xb, yb in dl:
                pred, _ = trainer.step(xb, yb, *extra)
                rep = trainer.last
                if args.log_steps:
                    log(INFO, "step %d: loss=%r", rep.index, rep.loss)
                out["step_losses"].append(rep.loss)
                out["steps"].append((rep.index, rep.loss))
                tot_loss += rep.loss
                tot_acc += accuracy(_global_rows(comm, pred), yb)
                nbatch += 1
                if rep.rolled_back:
                    rolled = True
                    break  # the cursor was rewound: re-enter the loader
            if rolled or not nbatch:
                continue
            dt = time.perf_counter() - t0
            log(INFO, "epoch %d: loss=%.4f acc=%.4f %.1f img/s", epoch,
                tot_loss / nbatch, tot_acc / nbatch, nbatch * bs / dt)
            out["epoch_losses"].append(tot_loss / nbatch)
            out["loss"], out["accuracy"] = (tot_loss / nbatch,
                                            tot_acc / nbatch)
    if args.verbosity:
        model.device.PrintTimeProfiling()
    return out


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("model", nargs="?", default="cnn",
                   choices=["cnn", "alexnet", "resnet18", "resnet34",
                            "resnet50", "resnet101", "resnet152",
                            "xceptionnet", "mobilenet", "vgg11", "vgg13",
                            "vgg16", "vgg19"])
    p.add_argument("-d", "--data", default="mnist",
                   choices=["mnist", "cifar10", "cifar100", "imagenet"])
    p.add_argument("-m", "--max-epoch", type=int, default=5)
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("-l", "--lr", type=float, default=0.005)
    p.add_argument("-n", "--num-samples", type=int, default=1024)
    p.add_argument("-g", "--graph", action="store_false", default=True,
                   help="disable graph mode (the captured step)")
    p.add_argument("-v", "--verbosity", type=int, default=0)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--data-dir", default=os.environ.get("SINGA_DATA_DIR"),
                   help="directory with real MNIST IDX / CIFAR pickle "
                        "files; synthetic data is used when absent")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ckpt", default=None,
                   help="checkpoint path; saved after every epoch")
    p.add_argument("--resume", action="store_true",
                   help="resume from --ckpt if it exists")
    p.add_argument("--ckpt-format", default="zip",
                   choices=["zip", "snapshot"])
    # resilient mode (singa_tpu_torch.resilience): --ckpt is a directory
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="checkpoint every N steps via CheckpointManager "
                        "(0 = per-epoch save_states)")
    p.add_argument("--ckpt-keep", type=int, default=3,
                   help="keep-last-K retention (resilient mode)")
    p.add_argument("--ckpt-sync", action="store_true",
                   help="block the training thread on checkpoint writes")
    p.add_argument("--watchdog", default="skip",
                   choices=["skip", "rollback", "raise"],
                   help="non-finite loss policy (resilient mode)")
    p.add_argument("--zero1", type=int, default=0,
                   help="shard optimizer state ZeRO-1 style over N ranks, "
                        "one process a rank")
    p.add_argument("--log-steps", action="store_true",
                   help="log every step's loss (full precision, for "
                        "bit-exact resume checks)")
    p.add_argument("--chaos-nan-step", type=int, default=None,
                   help="poison the batch of this step with NaNs")
    p.add_argument("--chaos-kill-step", type=int, default=None,
                   help="SIGKILL self at the top of this step")
    p.add_argument("--chaos-kill-save", type=int, default=0,
                   help="SIGKILL self during the Nth checkpoint write")
    p.add_argument("--chaos-kill-phase", default="staged",
                   choices=["staged", "published"],
                   help="where inside the write --chaos-kill-save fires")
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
