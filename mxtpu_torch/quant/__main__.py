"""``python -m mxtpu_torch.quant --self-check``: the committed
``contracts/quant_policy.json`` parses and keeps its class invariants,
and a calibrate → quantize round trip on a tiny two-layer net on the CPU
gives deterministic scales under one key a candidate, two int8 × int8 →
int32 products, an f32 output within tolerance of the float one, and
no int8 outside the scope."""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m mxtpu_torch.quant")
    parser.add_argument("--self-check", action="store_true",
                        help="probe policy parse + calibrate->quantize "
                             "round trip + scale bookkeeping")
    args = parser.parse_args(argv)
    if not args.self_check:
        parser.print_help()
        return 2
    from . import self_check
    return self_check(verbose=True)


if __name__ == "__main__":
    sys.exit(main())
