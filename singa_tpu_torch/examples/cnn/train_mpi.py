"""Data-parallel CNN training over hosts — the counterpart of the JAX
package's ``examples/cnn/train_mpi.py``.  One command a rank:

    python -m singa_tpu_torch.examples.cnn.train_mpi --coordinator \\
        host0:12345 --nprocs 4 --rank $RANK resnet50 -d imagenet

joins the group through :func:`~singa_tpu_torch.parallel.init_distributed`
(TCP at ``--coordinator``; unset arguments from ``WORLD_SIZE`` / ``RANK``;
the card of ``LOCAL_RANK`` or of the rank, or gloo with ``--device cpu``)
and runs ``train_multiprocess.run``; ``-b`` is the batch of one rank.
"""

from __future__ import annotations

import torch.distributed as dist

from ...parallel import init_distributed
from .train_multiprocess import parser as _parser
from .train_multiprocess import run


def parser():
    p = _parser()
    p.set_defaults(model="resnet50", data="imagenet", max_epoch=10)
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0")
    p.add_argument("--nprocs", type=int, default=None)
    p.add_argument("--rank", type=int, default=None)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    init_distributed(args.coordinator, args.nprocs, args.rank,
                     device=args.device)
    try:
        return run(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
