"""The port's counterparts of the repository's scripts that drive the JAX
package (``scripts/``), under the same names, each run with ``python -m``:

- ``make_synth_dataset``  layered fronto-parallel stereo scenes with exact
                          ground truth, byte-identical to
                          ``scripts/make_synth_dataset.py``
- ``rescale_transfer``    a trained ``.pt`` made ready for a finetune at
                          another width (``models.compat.
                          rescale_resolution_transfer``)
- ``convergence_run``     the convergence harness: ``card`` mode trains the
                          full-size model for many epochs on the GPU and
                          writes the trajectory and previews
"""
