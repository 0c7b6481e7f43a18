"""``python -m mxtpu_torch.obs`` — operator CLI for the observability
layer.

* ``--self-check`` (default): run :func:`mxtpu_torch.obs.self_check` and
  print the info dict; non-zero exit on contract violation.  Covers
  the zero-overhead null singletons (instruments, sampler, SLO
  engine, debug server), the text/JSON exposition round-trip, and an
  end-to-end probe of the operator layers on a fake clock: sampler
  windows, a driven burn-rate alert, every HTTP page rendering.
* ``--prom``: print the Prometheus text exposition of the process
  registry.
* ``--json``: print the JSON snapshot.
* ``--statusz``: print the ``/statusz`` operator page (SLO table,
  sampler stats, flight tails) as rendered for the debug HTTP server.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import http, prometheus_text, self_check, snapshot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mxtpu_torch.obs")
    ap.add_argument("--self-check", action="store_true",
                    help="assert the zero-overhead + round-trip "
                         "contracts (default action)")
    ap.add_argument("--prom", action="store_true",
                    help="print Prometheus text exposition")
    ap.add_argument("--json", action="store_true",
                    help="print JSON metrics snapshot")
    ap.add_argument("--statusz", action="store_true",
                    help="print the /statusz operator page JSON")
    args = ap.parse_args(argv)
    if args.prom:
        sys.stdout.write(prometheus_text())
        return 0
    if args.json:
        print(json.dumps(snapshot(), indent=2, default=str))
        return 0
    if args.statusz:
        print(http.render_statusz())
        return 0
    info = self_check()
    print(f"obs.self_check OK: {info}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
