"""The reference's six examples, run on the port.

Each module is run as ``python -m repro_torch.examples.<name>`` and has
``main(argv=None)``, which prints what the reference's example prints
and returns its numbers as a dict:

* ``quickstart``  -- a sparse matrix as an operator: storage, ``op @ x``,
  ``op.T @ y`` and the x-gradient;
* ``eigensolver`` -- Lanczos on the HMEp Hamiltonian, polished by
  shift-inverted inverse iteration through ``repro_torch.solve``;
* ``cg_solver``   -- distributed solves over ``dist_operator`` on eight
  ranks: CG in the three modes, Jacobi PCG, block CG, BiCGStab;
* ``serve_solver`` -- multi-tenant solve serving: registry, value swap,
  scheduler, deadlines, the metrics ledger;
* ``serve_lm``    -- continuous batching of six requests with the LM
  ``Engine``;
* ``train_lm``    -- a ~100 M-parameter model trained with AdamW, WSD,
  checkpoints, auto-resume and the straggler watchdog.

Every example runs on the card unless given ``--device cpu``, and
raises with neither a card nor a device.
"""
