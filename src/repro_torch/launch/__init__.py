"""Launch layer of the port, on one device without sharding: the step
kinds (``steps``: one FL round of a zoo model, the serving prefill and
decode), the inputs' shape-and-dtype stand-ins (``specs``), the training
CLI (``train``) and the serving CLI (``serve``).  Importing a module here
starts nothing."""
