"""Fresh gluon name counters for the port's parity tests.

Both packages number their Blocks per process (``dense0_``,
``dense1_``...), so the same network built in each has the same
parameter names only when both counters start alike.  ``fresh_names``
runs a build with empty counters in both packages (and, with
``symbols=True``, in both symbol modules, whose op nodes are numbered
the same way) and puts the process's counters back afterwards.
"""
import contextlib

import mxtpu.gluon.block as jblock
import mxtpu.symbol as jsym

import mxtpu_torch.gluon.block as tblock
import mxtpu_torch.symbol as tsym


@contextlib.contextmanager
def fresh_names(symbols=False):
    mods = [jblock, tblock] + ([jsym, tsym] if symbols else [])
    saved = [m._NAME_COUNTERS for m in mods]
    for m in mods:
        m._NAME_COUNTERS = {}
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m._NAME_COUNTERS = s
