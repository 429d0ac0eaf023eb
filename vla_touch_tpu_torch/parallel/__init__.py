"""Multi-device training and serving over ``torch.distributed`` (counterpart
of ``vla_touch_tpu/parallel/``), one process per GPU.

- :mod:`launch`: the process group (NCCL on ``cuda:<local rank>``, Gloo
  when the caller asks for the CPU), the rank and world queries, and each
  rank's rows of a global batch;
- :mod:`mesh`: the ``(data, model)`` device mesh and the JAX package's
  sharding rules, as tables of specs per parameter name;
- :mod:`comm`: the collectives the port uses (``all_reduce`` and
  ``all_gather``, which both backends take on CPU and CUDA tensors) and
  :class:`comm.Piece`, one mesh axis's slicing of a tensor;
- :mod:`tp`: Megatron tensor parallelism: the pair of autograd functions
  around a column- and a row-parallel product, the parallel linears, and
  the RDT blocks' sharding.

Typical use (one process per GPU, e.g. under ``torchrun``)::

    from vla_touch_tpu_torch.parallel import launch, mesh
    launch.initialize()                      # no-op without a launcher
    m = mesh.make_mesh(n_model=2)            # data axis spans the rest
    step_fn, plan = make_sharded_train_step(m, rcfg, tcfg)
"""
