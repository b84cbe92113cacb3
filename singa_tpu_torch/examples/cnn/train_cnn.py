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
``--resume`` restores it and goes on at the next epoch.

Not ported yet (each raises ``NotImplementedError``): ZeRO-1
(``--zero1``, DistOpt) and the resilient step-granular checkpoints
(``--ckpt-every``, ``resilience/``), both ROADMAP.md queue 1, item 12;
``--ckpt-format snapshot`` raises in ``Model.save_states`` as that
format does.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ... import opt, tensor
from ...device import get_device
from ...logging import INFO, InitLogging, LOG, SetVerbosity
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


def _not_ported(flag, what):
    raise NotImplementedError(f"{flag}: {what} belongs to a later slice of "
                              f"the port (ROADMAP.md queue 1, item 12)")


def run(args):
    """Train as the flags say; returns ``{"loss": the last epoch's mean
    loss, "accuracy": its accuracy, "epoch_losses": [...],
    "step_losses": [...]}``."""
    InitLogging("train_cnn")
    if args.zero1:
        _not_ported("--zero1", "ZeRO-1 (DistOpt over a communicator)")
    if args.ckpt_every:
        _not_ported("--ckpt-every", "resilient checkpointing "
                    "(singa_tpu's resilience/)")
    dev = get_device(args.device)
    np.random.seed(args.seed)
    dev.set_rand_seed(args.seed)

    x, y, source = loader.load(args.data, num=args.num_samples,
                               seed=args.seed, data_dir=args.data_dir)
    LOG(INFO, f"dataset {args.data}: {len(x)} samples from {source}")
    num_classes = int(y.max()) + 1
    model = create_model(args.model, num_classes=num_classes,
                         num_channels=x.shape[1])
    model.set_optimizer(opt.SGD(lr=args.lr, momentum=0.9, weight_decay=1e-5))

    bs = args.batch_size
    tx = tensor.Tensor(data=x[:bs], device=dev)
    ty = tensor.Tensor(data=y[:bs], device=dev)
    model.compile([tx], is_train=True, use_graph=args.graph,
                  sequential=False)
    SetVerbosity(args.verbosity)

    start_epoch = 0
    ckpt_exists = args.ckpt and (os.path.exists(args.ckpt)
                                 or os.path.exists(args.ckpt + ".bin"))
    if ckpt_exists and args.resume:
        # resume: params + optimizer state + epoch counter, no priming step
        aux = model.load_states(args.ckpt)
        start_epoch = int(aux.get("epoch", -1)) + 1
        LOG(INFO, "resumed from %s at epoch %d", args.ckpt, start_epoch)

    nb = len(x) // bs
    out = {"loss": float("nan"), "accuracy": float("nan"),
           "epoch_losses": [], "step_losses": []}
    for epoch in range(start_epoch, args.max_epoch):
        t0 = time.perf_counter()
        tot_loss, tot_acc = 0.0, 0.0
        idx = np.random.RandomState(args.seed + epoch).permutation(len(x))
        for b in range(nb):
            sel = idx[b * bs:(b + 1) * bs]
            tx.copy_from_numpy(x[sel])
            ty.copy_from_numpy(y[sel])
            pred, loss = model.train_one_batch(tx, ty)
            lv = float(loss.item())
            if args.log_steps:
                LOG(INFO, "step %d: loss=%r", epoch * nb + b, lv)
            out["step_losses"].append(lv)
            tot_loss += lv
            tot_acc += accuracy(pred.numpy(), y[sel])
        dt = time.perf_counter() - t0
        LOG(INFO, "epoch %d: loss=%.4f acc=%.4f %.1f img/s", epoch,
            tot_loss / nb, tot_acc / nb, nb * bs / dt)
        out["epoch_losses"].append(tot_loss / nb)
        out["loss"], out["accuracy"] = tot_loss / nb, tot_acc / nb
        if args.ckpt:
            model.save_states(args.ckpt,
                              aux_states={"epoch": np.asarray(epoch)},
                              format=args.ckpt_format)
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
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="not ported yet: raises NotImplementedError")
    p.add_argument("--zero1", type=int, default=0,
                   help="not ported yet: raises NotImplementedError")
    p.add_argument("--log-steps", action="store_true",
                   help="log every step's loss (full precision)")
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
