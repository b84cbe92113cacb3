"""The CNN model zoo of the port: :mod:`.cnn`, :mod:`.resnet`
(18/34/50/101/152), :mod:`.alexnet`, :mod:`.vgg`, :mod:`.mobilenet` and
:mod:`.xceptionnet` — the JAX package's ``examples/cnn/model``, with the
same layer attribute names, so ``get_states()`` names are the JAX
model's and states cross by name both ways."""

from ....autograd import softmax_cross_entropy
from ....model import Model

__all__ = ["Classifier"]


class Classifier(Model):
    """The zoo's training step (each reference model has its own copy):
    logits, mean softmax cross-entropy, the optimizer, ``(out, loss)``.
    ``dist_option`` other than ``"plain"`` names a ``DistOpt`` update
    (fp16, partial, sparse, ZeRO-1), which belongs to a later slice of
    the port (ROADMAP.md queue 1, item 12)."""

    softmax_cross_entropy = staticmethod(softmax_cross_entropy)

    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        if dist_option != "plain":
            raise NotImplementedError(
                f"dist_option {dist_option!r} needs DistOpt, which belongs "
                f"to a later slice of the port (ROADMAP.md queue 1, item 12)")
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss
