"""The port's entry points, each ``python -m tomosar2height_tpu_torch.cli.<name>
key=value ...`` with the overrides of ``conf/``: ``build_dataset`` (chunk a
city on disk), ``train`` and ``test`` (the counterparts of the JAX
package's ``scripts/build_dataset.py``, ``train.py`` and ``test.py``)."""
