"""Command-line tools of the port: the TCP soak (``tools.soak``), the
recognition-accuracy study (``tools.accuracy_study``) and the margin
acceptance study (``tools.margin_study``). Each runs on ``cuda`` unless
``--device cpu`` is given: ``python -m tiresias_tpu_torch.tools.soak``."""
