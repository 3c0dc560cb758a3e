"""The benchmark of the PyTorch and CUDA port (``svc_inference_pipeline_tpu_torch``).

``portbench/run.py`` runs one cell; ``portbench/README.md`` says how to add
a configuration, a traffic mix, a loop kind or a metric as new files."""
