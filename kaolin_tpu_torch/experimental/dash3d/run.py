"""kaolin-dash3d: web viewer for Timelapse checkpoints.

Port of ``kaolin_tpu/experimental/dash3d/run.py``.  One tornado app serves
both HTTP (the bundled JS/WebGL client, ``static/``) and the geometry
websocket.  tornado is imported only when the server starts.

Usage::

    python -m kaolin_tpu_torch.experimental.dash3d.run \\
        --logdir=$MY_EXPERIMENT_DIR --port=8080
"""

import argparse
import json
import logging
import os

logger = logging.getLogger(__name__)

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'static')


def create_server(logdir, port=8080):
    """Build the tornado application and listen on ``port``."""
    import tornado.web
    import tornado.websocket
    from kaolin_tpu_torch.experimental.dash3d.util import (
        StreamingGeometryHelper)

    helper = StreamingGeometryHelper(logdir)

    class IndexHandler(tornado.web.RequestHandler):
        def get(self):
            with open(os.path.join(STATIC_DIR, 'index.html')) as f:
                self.write(f.read())

    class SummaryHandler(tornado.web.RequestHandler):
        def get(self):
            helper.refresh()
            self.set_header('Content-Type', 'application/json')
            self.write(json.dumps(helper.summary()))

    class GeometryWebSocketHandler(tornado.websocket.WebSocketHandler):
        """Streams binary geometry on request."""

        def on_message(self, message):
            req = json.loads(message)
            typ = req.get('type', 'mesh')
            category = req.get('category', '')
            idx = int(req.get('id', 0))
            time = req.get('time')
            helper.refresh()
            if typ == 'mesh':
                payload = helper.get_mesh_message(category, idx, time)
            else:
                payload = helper.get_pointcloud_message(category, idx, time)
            if payload is None:
                self.write_message(json.dumps(
                    {'error': f'{typ} {category}/{idx} not found'}))
            else:
                self.write_message(payload, binary=True)

    app = tornado.web.Application([
        (r'/', IndexHandler),
        (r'/summary', SummaryHandler),
        (r'/websocket', GeometryWebSocketHandler),
        (r'/static/(.*)', tornado.web.StaticFileHandler,
         {'path': STATIC_DIR}),
    ])
    app.listen(port)
    return app


def get_max_viewports(urlargs):
    """Clamp the requested number of viewports to [1, 8] (default 3)."""
    default_val = 3
    try:
        res = int(urlargs.get('maxviews', default_val))
        res = max(1, min(8, res))
    except Exception:
        res = default_val
    return res


def main():
    parser = argparse.ArgumentParser(description='kaolin-dash3d web viewer')
    parser.add_argument('--logdir', type=str, required=True,
                        help='Timelapse log directory to visualize')
    parser.add_argument('--port', type=int, default=8080)
    args = parser.parse_args()

    import tornado.ioloop
    logging.basicConfig(level=logging.INFO)
    logger.info(f'Serving dash3d for {args.logdir} on port {args.port}')
    create_server(args.logdir, args.port)
    tornado.ioloop.IOLoop.current().start()


# the entry-point name of kaolin's dash3d
run_main = main


if __name__ == '__main__':
    main()
