"""Chained-measurement tools of the port: the counterparts of the JAX
package's ``tools/microbench.py``, ``tools/probe_conv_strategies.py``,
``tools/bench_flash.py`` and ``tools/probe_bn_fusion.py``.

Each runs on the card by default (``python -m mxtpu_torch.tools.<name>``)
and on the CPU only when asked (``--device cpu``), where the kernels'
plain versions stand in and no time means anything about the card.
``step_times`` and ``kernel_times`` have no JAX counterpart: they time
``TrainStep`` steps, and the NMS call and the MoE route kernel, for the
``mxtpu_torch`` of any source tree and run by their paths (``python3
mxtpu_torch/tools/step_times.py --tree DIR``), so that a commit and its
parent are timed in one session.
"""
