"""Environment smoke checks for the PyTorch port (the JAX package's
``scripts/check_environment.py``): torch and its devices, the package
import, a tiny DiT forward on the chosen device, and on a CUDA device the
hand-written kernels' build and one flash-attention launch against its
plain twin.

  python -m chronoedit_tpu_torch.scripts.check_environment            # the card
  python -m chronoedit_tpu_torch.scripts.check_environment --device cpu

Exits 1 when any check fails.
"""

from __future__ import annotations

import argparse
import sys

import torch


def check(name, fn) -> bool:
    try:
        msg = fn()
        print(f"[ok]   {name}" + (f": {msg}" if msg else ""))
        return True
    except Exception as e:  # noqa: BLE001 - report every check, then exit
        print(f"[FAIL] {name}: {type(e).__name__}: {e}")
        return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the first CUDA card")
    args = p.parse_args(argv)
    device = []

    def torch_devices():
        from chronoedit_tpu_torch.utils.platform import cuda_device

        device.append(cuda_device() if args.device is None else torch.device(args.device))
        cards = torch.cuda.device_count()
        name = torch.cuda.get_device_name(0) if cards else "no CUDA card"
        return (f"torch {torch.__version__} (CUDA {torch.version.cuda}), {cards} card(s): "
                f"{name}; running on {device[0]}")

    ok = check("torch + devices", torch_devices)
    ok &= check("chronoedit_tpu_torch import",
                lambda: __import__("chronoedit_tpu_torch").__name__)

    def tiny_forward():
        from chronoedit_tpu_torch.configs import chronoedit_tiny
        from chronoedit_tpu_torch.models import dit as dit_lib

        cfg = chronoedit_tiny().dit
        model = dit_lib.init_dit_params(cfg, torch.Generator(device=device[0]).manual_seed(0),
                                        device[0])
        with torch.inference_mode():
            out = dit_lib.dit_forward(
                model, torch.zeros((1, cfg.in_channels, 2, 4, 4), device=device[0]),
                torch.zeros((1,), device=device[0]),
                torch.zeros((1, 4, cfg.text_dim), device=device[0]),
                torch.zeros((1, cfg.image_tokens, cfg.image_dim), device=device[0]))
        return f"DiT forward {tuple(out.shape)} on {out.device}"

    def flash_kernel():
        if device[0].type != "cuda":
            return "skipped (not a CUDA device)"
        from chronoedit_tpu_torch.ops import flash_attention as fa

        g = torch.Generator(device=device[0]).manual_seed(0)
        q = torch.randn((1, 256, 2, 128), generator=g, device=device[0]).to(torch.bfloat16)
        out = fa.flash_attention(q, q, q, 128 ** -0.5)
        ref = fa.flash_attention_plain(q.float(), q.float(), q.float(), 128 ** -0.5)[0]
        err = float((out.float() - ref).abs().max())
        if not err < 2e-2:
            raise AssertionError(f"max error {err} against the twin")
        return f"flash_attention {tuple(out.shape)}, max error {err:.2e} against the twin"

    if ok:
        ok &= check("tiny DiT forward", tiny_forward)
        ok &= check("hand-written flash attention", flash_kernel)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
