"""Launch layer of the port: the serving step kinds (``steps``) and the
serving CLI (``serve``), on one device without sharding.  Importing a
module here starts nothing."""
