"""PyTorch + CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

Module names mirror ``repro`` so each counterpart is easy to find. The
port imports ``torch`` and numpy only -- never ``jax`` and nothing of
``repro`` (it keeps its own copies of the framework-free modules).

Entry points (``models.transformer.init_params``, the serving engines,
``launch.serve``, ``train.trainer.run_decentralized``,
``examples.quickstart``) run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
Every kernel wrapper runs its plain PyTorch version for CPU tensors and
launches its hand-written kernel (or raises) for CUDA tensors.
"""
