"""The port's operator entry points that drive the system, as modules.

Counterparts of the JAX package's ``scripts/chaos_sweep.py`` and
``scripts/wf_profile.py``: each runs on the card
(``python -m windflow_tpu_torch.scripts.<name>``), or on the CPU with
``--device cpu`` (``wf_profile``'s summary mode reads artifacts and needs no
device); without a card and without ``--device cpu`` the drivers raise, as
the port's entry points do.
"""
