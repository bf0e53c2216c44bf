"""Training support used by ``MultiLayerNetwork.fit``: telemetry and
iteration listeners (port of parts of ``deeplearning4j_tpu/optimize``)."""
