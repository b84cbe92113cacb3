"""Models of the port (counterpart: ``singa_tpu/models``)."""

from .gpt import GPT, GPTConfig

__all__ = ["GPT", "GPTConfig"]
