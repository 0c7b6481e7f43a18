"""``python -m mxtpu_torch.amp --self-check``: the committed
``contracts/amp_policy.json`` parses and keeps its class invariants, an
autocast round trip on the CPU gives the f32 product of the bf16-rounded
operands with f32 gradients (and nothing outside the scope), and the
loss scaler's grow/backoff/skip accounting is exact."""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m mxtpu_torch.amp")
    parser.add_argument("--self-check", action="store_true",
                        help="probe policy parse + autocast round trip "
                             "+ scaler units")
    args = parser.parse_args(argv)
    if not args.self_check:
        parser.print_help()
        return 2
    from . import self_check
    return self_check(verbose=True)


if __name__ == "__main__":
    sys.exit(main())
