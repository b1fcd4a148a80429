"""End-to-end training on the PyTorch port: the ~135M-parameter smollm
config on the synthetic pipeline with checkpointing and restart, through
``python -m repro_torch.launch.train``.

The twin of ``examples/train_lm.py``, with its flags: the REDUCED config
for 300 steps by default (the same code path as production), batch 8 of
128 tokens, a checkpoint every 100 steps, a log line (loss, lr, gnorm) every
20; ``--full`` takes the real 135M config at batch 2.  Checkpoints go to
``build/train_lm_example`` in the checkout (the reference writes
``/tmp/repro_train_lm``); a second run there resumes.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] [--full] [--steps 300]
"""
import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT_DIR = os.path.join(HERE, "..", "build", "train_lm_example")


def command(steps: int = 300, full: bool = False, device=None, ckpt_dir: str = CKPT_DIR) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "smollm-135m",
           "--steps", str(steps),
           "--batch", "8" if not full else "2",
           "--seq-len", "128",
           "--ckpt-dir", ckpt_dir,
           "--ckpt-every", "100",
           "--log-every", "20"]
    if not full:
        cmd.append("--smoke")
    return cmd + (["--device", device] if device else [])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="full 135M config (slow on CPU)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args = ap.parse_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    raise SystemExit(subprocess.call(command(args.steps, args.full, args.device, args.ckpt_dir),
                                     env=env))


if __name__ == "__main__":
    main()
