"""Serve a small model on the PyTorch port with batched requests: prefill and
greedy decode through ``python -m repro_torch.launch.serve``.

The twin of ``examples/serve_lm.py``, with its flags: the qwen2.5-14b smoke
config, 4 prompts of 32 tokens, 16 decoded tokens.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def command(device=None) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--arch", "qwen2.5-14b", "--smoke",
           "--batch", "4", "--prompt-len", "32", "--decode-steps", "16"]
    return cmd + (["--device", device] if device else [])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    raise SystemExit(subprocess.call(command(args.device), env=env))


if __name__ == "__main__":
    main()
