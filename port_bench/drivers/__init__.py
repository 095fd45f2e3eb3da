"""One module a kind of traffic (a mix's ``kind``): how a session sets the
program up for the window, drives the window, counts failed units and
decides what the check compares. ``session.Session`` finds
``drivers/<kind>.py`` by the mix's kind, so a new kind of traffic is a new
file here and a mix that names it."""
