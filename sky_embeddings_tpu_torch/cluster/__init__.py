"""Job queueing for GPU training runs: the chained-allocation queue
(``queue_gpu``) and the pretraining and predictor launchers (port of
``sky_embeddings_tpu/cluster/``)."""
