# Serving image for the tpu2048 web service (all 7 UI modes).
# Counterpart of the reference's python:3.11-slim Dash image
# (/root/reference/Dockerfile:1-14): same capability — a
# self-contained container exposing the web app — but running the
# stdlib-HTTP service over the JAX engine instead of Flask/Dash.
#
# CPU image by default; for an NVIDIA GPU install "jax[cuda12]" instead
# of "jax" and run the container with the GPU visible.

FROM python:3.12-slim

WORKDIR /app
COPY pyproject.toml ./
COPY tpu2048 ./tpu2048
COPY docs ./docs
COPY bench.py ./

RUN pip install --no-cache-dir "jax>=0.4.30" numpy

ENV TPU2048_STORE=/data
ENV PORT=5000
VOLUME /data
EXPOSE 5000

CMD ["python", "-m", "tpu2048.apps.server", "--host", "0.0.0.0"]
