"""The sharded multi-device step: a slot mesh (``mesh``), the halo exchange
(``halo``), the sharded levels, cascade, defocus and batched step
(``sharded``), and a dry run of it (``dryrun``)."""
