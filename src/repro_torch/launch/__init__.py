"""Entry points: ``python -m repro_torch.launch.serve``, ``.train``,
``.train_nmt``, ``.dryrun``, and one launcher for each of the examples
(``.quickstart``, ``.collaborative_serving``, ``.multitier_serving``,
``.partitioned_serving``, ``.fault_tolerant_serving``,
``.big_model_serving``, ``.continuous_serving``)."""
