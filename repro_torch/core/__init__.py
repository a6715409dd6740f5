"""The N-to-M checkpoint engine, as the port carries it.

``comm``, ``star_forest``, ``chunk_layout``, ``store``, ``tensor_ckpt``,
``directory``, ``resharder`` and ``async_io`` are copies of the JAX
package's NumPy engine (they never imported JAX),
kept here so the port imports nothing of that package.  Two things differ:
the static-analysis markers are gone, and ``store`` carries bfloat16 as
2-byte host words (``store.HOST_WORDS``) instead of through ``ml_dtypes``,
while writing the same ``store.json`` and content hashes.  ``torch_io`` is
the PyTorch bridge (the counterpart of ``jax_io``).
"""
