"""The live editing path: the session (``session.DepthSession``), the
command line (``cli.main``) and the OpenCV loop (``gui.run_gui``, which
imports cv2 when it is called)."""
