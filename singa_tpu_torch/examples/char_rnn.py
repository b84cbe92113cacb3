"""Char-RNN language model on the port — the counterpart of the JAX
package's ``examples/rnn/train.py`` (the reference's cuDNN-LSTM char model
with truncated BPTT and sampling).

    python -m singa_tpu_torch.examples.char_rnn [--device cuda|cpu] ...

The LSTM is :class:`singa_tpu_torch.layer.LSTM`: the input product is one
matmul over the whole sequence, and the recurrence a loop over T (with
``use_fused_cell``, one launch of the fused cell kernel a step).  The
hidden state carries across chunks (truncated BPTT): the graph-mode step
returns it cut from the step's graph, so the next step's gradient stops
there.  The default corpus is generated with deterministic structure so
the model demonstrably learns; ``--corpus FILE`` trains on real text.
The flags are the JAX example's; ``--device`` is ``cuda`` (the default)
or ``cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from .. import autograd, layer, opt, tensor
from ..device import get_device
from ..model import Model

LOG = logging.getLogger("train_rnn")


def synthetic_corpus(n_chars=20000, seed=0):
    """Markov-ish text with strong local structure for the LM to learn."""
    rng = np.random.RandomState(seed)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy",
             "dogs", "and", "cats", "run", "far"]
    out = []
    while sum(len(w) + 1 for w in out) < n_chars:
        k = rng.randint(3, 8)
        sent = [words[rng.randint(len(words))] for _ in range(k)]
        out.append(" ".join(sent) + ".")
    return " ".join(out)[:n_chars]


class Data:
    def __init__(self, text):
        self.chars = sorted(set(text))
        self.vocab = len(self.chars)
        self.c2i = {c: i for i, c in enumerate(self.chars)}
        self.ids = np.array([self.c2i[c] for c in text], np.int32)

    def batches(self, bs, seq):
        n = (len(self.ids) - 1) // (bs * seq)
        x = self.ids[:n * bs * seq].reshape(bs, n * seq)
        y = self.ids[1:n * bs * seq + 1].reshape(bs, n * seq)
        for i in range(n):
            # (T, B) seq-major, one-hot on the fly in the model
            yield (x[:, i * seq:(i + 1) * seq].T.copy(),
                   y[:, i * seq:(i + 1) * seq].T.copy())


class CharRNN(Model):
    def __init__(self, vocab, hidden=256, num_layers=1):
        super().__init__()
        self.vocab = vocab
        self.hidden = hidden
        self.lstm = layer.LSTM(hidden, num_layers=num_layers)
        self.fc = layer.Linear(vocab)

    def forward(self, x, hx=None, cx=None):
        # x: (T, B) int ids -> one-hot (T, B, V)
        xoh = autograd.onehot(x, self.vocab)
        y, hy, cy = self.lstm(xoh, hx, cx)
        T, B = y.shape[0], y.shape[1]
        logits = self.fc(autograd.reshape(y, (T * B, self.hidden)))
        return logits, hy, cy

    def train_one_batch(self, x, y, hx, cx):
        logits, hy, cy = self.forward(x, hx, cx)
        flat_y = autograd.reshape(y, (y.shape[0] * y.shape[1],))
        loss = autograd.softmax_cross_entropy(logits, flat_y)
        self.optimizer(loss)
        return loss, hy, cy


def sample(model, data, dev, length=120, seed_char="t", temperature=0.8,
           rng=None):
    """``length`` characters after ``seed_char``, one forward step of
    T 1, B 1 each, drawn from the softmax at ``temperature`` with
    ``rng`` (a seeded numpy generator by default).  The logits come to
    the host through ``Tensor.numpy()``."""
    rng = rng or np.random.RandomState(0)
    model.eval()
    ids = [data.c2i.get(seed_char, 0)]
    hx = cx = None
    for _ in range(length):
        x = tensor.Tensor(data=np.array([[ids[-1]]], np.int32), device=dev)
        logits, hx, cx = model.forward(x, hx, cx)
        p = logits.numpy().astype(np.float64)[0] / temperature
        p = np.exp(p - p.max())
        p /= p.sum()
        ids.append(int(rng.choice(len(p), p=p)))
    model.train()
    return "".join(data.chars[i] for i in ids)


def run(args):
    if args.export_onnx:
        raise NotImplementedError(
            "--export-onnx needs sonnx, which belongs to a later slice of "
            "the port (ROADMAP.md queue 1, item 12: sonnx.py)")
    dev = get_device(args.device)
    np.random.seed(args.seed)
    dev.set_rand_seed(args.seed)
    if args.corpus and os.path.exists(args.corpus):
        with open(args.corpus, encoding="utf-8", errors="ignore") as f:
            text = f.read()
    else:
        text = synthetic_corpus()
    data = Data(text)
    LOG.info("corpus: %d chars, vocab %d", len(text), data.vocab)

    m = CharRNN(data.vocab, args.hidden, args.num_layers)
    m.set_optimizer(opt.Adam(lr=args.lr))

    B, T = args.batch_size, args.seq_len
    zeros = np.zeros((args.num_layers, B, args.hidden), np.float32)
    tx = tensor.Tensor(data=np.zeros((T, B), np.int32), device=dev)
    ty = tensor.Tensor(data=np.zeros((T, B), np.int32), device=dev)
    m.compile([tx], is_train=True, use_graph=True)

    tot, nb = 0.0, 0
    for epoch in range(args.max_epoch):
        t0 = time.perf_counter()
        tot, nb = 0.0, 0
        hx = tensor.Tensor(data=zeros, device=dev)
        cx = tensor.Tensor(data=zeros, device=dev)
        for bx, by in data.batches(B, T):
            tx.copy_from_numpy(bx)
            ty.copy_from_numpy(by)
            loss, hy, cy = m.train_one_batch(tx, ty, hx, cx)
            hx, cx = hy, cy  # truncated BPTT: carry state, cut gradient
            tot += float(loss.item())
            nb += 1
        dt = time.perf_counter() - t0
        LOG.info("epoch %d: loss=%.4f %.0f chars/s", epoch,
                 tot / max(nb, 1), nb * B * T / dt)
    LOG.info("sample: %s", sample(m, data, dev)[:200])
    return tot / max(nb, 1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus", default=None)
    p.add_argument("-m", "--max-epoch", type=int, default=5)
    p.add_argument("-b", "--batch-size", type=int, default=16)
    p.add_argument("-t", "--seq-len", type=int, default=64)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=1)
    p.add_argument("-l", "--lr", type=float, default=3e-3)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--export-onnx", default=None, metavar="PATH",
                   help="not ported yet: raises NotImplementedError")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    main()
