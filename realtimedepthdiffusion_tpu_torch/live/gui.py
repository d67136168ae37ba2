"""OpenCV HighGUI front-end (port of ``realtimedepthdiffusion_tpu/live/gui.py``):
the reference's window, mouse and key contract (src/main.cpp:175-334)
driving the session.

Windows: "Original Image", "Edited Image" (paint target), "Depth Image",
plus "Artistic Image" once an effect is active. Mouse-drag paints on the
Edited Image; keys are documented in live/session.py. The UI ticks at
waitKey(33), about 30 Hz, like the reference (src/main.cpp:187).

OpenCV is only the display and event surface, imported when ``run_gui``
is called; the rest of the port runs without it. Display arrays are
converted RGB->BGR at the boundary.
"""

from __future__ import annotations

from .session import DepthSession


def handle_key(session: DepthSession, key: int, live: bool = False) -> bool:
    """Apply one key event (the reference's key contract,
    src/main.cpp:180-334) to the session; returns True when the loop should
    exit (Esc). ``key`` is the raw waitKey byte (-1/255 = none).
    """
    if key == 27:  # Esc
        return True
    ch = chr(key) if 32 <= key < 127 else ""

    # The reference's per-frame branches are independent ifs
    # (src/main.cpp:188-332): one frame can change color, latch an effect,
    # solve, save, print timing and resize the brush all at once, and under
    # --live the solve runs every frame regardless of other keys. A sticky
    # effect also re-renders every frame (`key=='b' || refocusEffect`,
    # src/main.cpp:190), not just on its keypress.
    if ch.isdigit():
        session.set_color_key(int(ch))
    if ch and ch in "bBgGhH":
        session.set_effect_key(ch)
    solving = (ch and ch in "dD") or live
    if session.effect and not solving:
        # solve() renders the active effect with the solve (from the fresher
        # post-solve depth); only render separately on frames without one.
        session.render_effect()
    if solving:
        session.solve()
    if ch and ch in "sS":
        session.save(".")
        print("Saving images...")
    if ch and ch in "tT":
        print(session.timing_report())
    if ch == "-":
        session.adjust_radius(-2)
        print(f"Scribble Radius: {session.scribble_radius}")
    if ch == "+":
        session.adjust_radius(+2)
        print(f"Scribble Radius: {session.scribble_radius}")
    return False


def run_gui(session: DepthSession, live: bool = False) -> int:
    try:
        import cv2  # I/O boundary import
    except ImportError as e:
        raise ImportError("run_gui needs OpenCV (cv2) for its windows; run headless "
                          "(--headless) where cv2 is not installed") from e

    from ..native.runtime import EventQueue

    # OpenCV fires mouse callbacks on its own thread; events go through the
    # native MPSC ring buffer and are drained on the solve-loop thread.
    events = EventQueue(capacity=4096)
    state = {"pressed": False}

    def on_mouse(event, x, y, flags, _userdata):
        if event == cv2.EVENT_LBUTTONDOWN:
            state["pressed"] = True
        elif event == cv2.EVENT_LBUTTONUP:
            state["pressed"] = False
        if event == cv2.EVENT_MOUSEMOVE and state["pressed"]:
            events.push(EventQueue.KIND_PAINT, x, y, 0)

    def bgr(rgb):
        return rgb[..., ::-1]

    cv2.namedWindow("Original Image")
    cv2.namedWindow("Edited Image")
    cv2.namedWindow("Depth Image")
    cv2.setMouseCallback("Edited Image", on_mouse)

    quit_requested = False
    while not quit_requested:
        # Drain the queue on this (solve-loop) thread: paint events from the
        # mouse thread, key events from the previous UI tick. Every frame
        # ends in exactly one handle_key pass so the per-frame contract
        # (live solve + sticky effect render) runs even with no key pressed.
        frame_key = 255
        while (ev := events.pop()) is not None:
            if ev[0] == EventQueue.KIND_PAINT:
                session.paint(ev[1], ev[2])
            elif ev[0] == EventQueue.KIND_KEY:
                frame_key = ev[1]
        quit_requested = handle_key(session, frame_key, live)
        if quit_requested:
            break

        cv2.imshow("Original Image", bgr(session.rgb_np))
        cv2.imshow("Edited Image", bgr(session.edited_image()))
        cv2.imshow("Depth Image", session.depth_image())
        if session.effect and session.artistic is not None:
            cv2.imshow("Artistic Image", bgr(session.artistic.cpu().numpy()))

        key = cv2.waitKey(33) & 0xFF
        if key != 255:
            events.push(EventQueue.KIND_KEY, key)

    events.close()
    cv2.destroyAllWindows()
    return 0
