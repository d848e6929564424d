"""Cost, collective and roofline accounting for the dry run
(``launch/dryrun.py``), and its report tables."""
