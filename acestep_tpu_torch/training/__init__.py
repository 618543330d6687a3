"""Training of the port: the flow-matching loss and optimizer
(``flow_matching``), LoRA and LoKr adapters (``lora``, ``lokr``), datasets
(``data``, ``dataset_builder``) and the ``trainer``."""
