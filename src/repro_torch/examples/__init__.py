"""The port's four examples, the twins of the repo's ``examples/`` scripts
(which drive the JAX package): each runs as
``python -m repro_torch.examples.<name>``.

* ``quickstart``: probabilistic pruning (Ch. 5) and task merging (Ch. 4)
  on the simulator; prints what ``examples/quickstart.py`` prints.
* ``oversubscription_demo``: the control-plane signals under an
  oversubscription wave; prints what ``examples/oversubscription_demo.py``
  prints.
* ``serve_smse``: the cluster front door over SMSE engine planes serving
  real generations of a reduced smollm-family model on the card
  (``--device``, CUDA by default).
* ``train_100m``: a ~100 M-parameter smollm-family model trained with
  checkpoints and resume on the card (``--device``, CUDA by default).

The launchers (``repro_torch.launch``) remain the port's entry points;
these are the walk-throughs.
"""
