"""The port stands alone: no module of singa_tpu_torch, and not
chip_smoke.py, imports jax, the JAX package (singa_tpu), google.protobuf
or ml_dtypes; the package imports with jax made unimportable, and its
protobuf codec and snapshots work with google.protobuf and ml_dtypes
made unimportable."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "singa_tpu_torch")):
        dirs.sort()               # one collection order in every worker
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "singa_tpu", "google", "ml_dtypes")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_singa_tpu_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_package_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['singa_tpu'] = None\n"
            "import singa_tpu_torch, singa_tpu_torch.serving\n"
            "import singa_tpu_torch.models.gpt\n"
            "import singa_tpu_torch.tensor, singa_tpu_torch.autograd\n"
            "import singa_tpu_torch.layer, singa_tpu_torch.model\n"
            "import singa_tpu_torch.opt, singa_tpu_torch.device\n"
            "from singa_tpu_torch.device import (\n"
            "    DeviceMemPool, Platform, get_default_device,\n"
            "    set_default_device, create_cpu_device, create_cuda_gpu_on)\n"
            "from singa_tpu_torch.tensor import (\n"
            "    Einsum, GEMM, Gather, SoftMax, Uniform, float64)\n"
            "import singa_tpu_torch.precision\n"
            "import singa_tpu_torch.parallel\n"
            "import singa_tpu_torch.examples.cnn.train_multiprocess\n"
            "import singa_tpu_torch.examples.cnn.train_mpi\n"
            "import singa_tpu_torch.ops.flash_attention\n"
            "import singa_tpu_torch.ops.paged_attention\n"
            "import singa_tpu_torch.ops._build\n"
            "import singa_tpu_torch.ops.lstm_cell\n"
            "import singa_tpu_torch.ops.elementwise\n"
            "import singa_tpu_torch.ops.rnn\n"
            "import singa_tpu_torch.examples.char_rnn\n"
            "import singa_tpu_torch.logging, singa_tpu_torch.loss\n"
            "import singa_tpu_torch.metric\n"
            "import singa_tpu_torch.ops.convolution\n"
            "import singa_tpu_torch.ops.batchnorm\n"
            "import singa_tpu_torch.ops.pooling\n"
            "import singa_tpu_torch.examples.mlp\n"
            "import singa_tpu_torch.examples.cnn.train_cnn\n"
            "from singa_tpu_torch.examples.cnn.model import (\n"
            "    alexnet, cnn, mobilenet, resnet, vgg, xceptionnet)\n"
            "import singa_tpu_torch.proto, singa_tpu_torch.proto.wire\n"
            "import singa_tpu_torch.proto.core, singa_tpu_torch.snapshot\n"
            "import singa_tpu_torch.data\n"
            "import singa_tpu_torch.telemetry.tracer\n"
            "import singa_tpu_torch.telemetry.registry\n"
            "from singa_tpu_torch.telemetry import (\n"
            "    SpanTracer, MetricsRegistry, default_registry)\n"
            "import singa_tpu_torch.resilience.checkpoint\n"
            "import singa_tpu_torch.resilience.trainer\n"
            "import singa_tpu_torch.resilience.faults\n"
            "from singa_tpu_torch.resilience import (\n"
            "    CheckpointManager, ResilientTrainer, TrainFaultPlan)\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
            "                     if sys.modules[m] is not None]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_codec_and_snapshot_import_without_protobuf_or_ml_dtypes(tmp_path):
    """``singa_tpu_torch.proto`` and ``singa_tpu_torch.snapshot`` encode,
    write, read and decode a bfloat16 record with google.protobuf and
    ml_dtypes unimportable, and load neither."""
    code = ("import sys\n"
            "for m in ('google.protobuf', 'ml_dtypes', 'jax', 'singa_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "from singa_tpu_torch.proto import TensorProto\n"
            "from singa_tpu_torch.snapshot import Snapshot\n"
            "t = TensorProto(shape=[2, 300], data_type=6, data=b'ab')\n"
            "assert t.SerializeToString() == \\\n"
            "    b'\\n\\x03\\x02\\xac\\x02\\x10\\x06\\x1a\\x02ab'\n"
            f"sn = Snapshot({str(tmp_path / 'snap')!r}, True)\n"
            "sn.write('w', torch.tensor([1.5, -2.0]).bfloat16())\n"
            "sn.done()\n"
            f"got = Snapshot({str(tmp_path / 'snap')!r}, False).read()['w']\n"
            "assert got.dtype == torch.bfloat16\n"
            "assert got.float().tolist() == [1.5, -2.0]\n"
            "bad = [m for m in sys.modules if sys.modules[m] is not None\n"
            "       and (m.startswith('google.protobuf')\n"
            "            or m.split('.')[0] in ('ml_dtypes', 'jax'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
