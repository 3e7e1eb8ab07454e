"""Launch layer of the port: the step kinds (``steps``: one FL round of a
zoo model, the serving prefill and decode, on one device or on a mesh),
the inputs' shape-and-dtype stand-ins (``specs``), the meshes and sharding
rules (``mesh``, ``sharding``), the dry run and its roofline terms
(``dryrun``, ``roofline``), the training CLI (``train``) and the serving
CLI (``serve``).  Importing a module here starts nothing."""
