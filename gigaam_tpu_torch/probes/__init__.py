"""Probes: the benchmark probes of ``benchmarks/`` on the card.

Each module here is the counterpart of one probe script of the JAX package:
its kernels are written by hand for Hopper (``gigaam_tpu_torch/csrc``), each
beside its plain PyTorch version, and its runners time them.  A probe is a
measurement, not a path of the model: nothing else in the port calls it.

* ``sdpa_ablation``: K3's kernel with one thing changed at a time
  (``benchmarks/sdpa_ablation.py``).
* ``fold_probes``: the FFN and conv-module sub-blocks, LayerNorm and
  residual included, each folded into hand-written kernels and timed
  against the stock compositions (``benchmarks/pallas_ffn_fold_probe.py``,
  ``benchmarks/pallas_conv_fold_probe.py``).
* ``subsampling_probe``: the subsampling's stride-2 conv as nine tap
  products (P1) and as an im2col patch with one long product (P2), each
  timed against cuDNN's conv, and the largest shared memory a block is
  granted (P3) (``benchmarks/pallas_subsampling_probe.py``).
* ``attn_fold_probes``: the rotary attention module as K1/K2 run it, with
  the projection GEMMs tiled other ways (64-row tiles with N-128 or per-head
  N-48 columns, 128- and 256-row tiles: P6, P7) and with the residual added
  in fp32 (P8), timed against the composed path, K2/K1 and a lean stock
  path (``benchmarks/pallas_attn_fold_probe.py``,
  ``benchmarks/pallas_attn_lnres_probe.py``).
"""
