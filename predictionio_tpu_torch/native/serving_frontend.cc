// Continuous-batching serving frontend — the native `pio deploy --native`
// and `pio eventserver --native` hot path of the PyTorch port.
//
// The port's own copy of the reference's native/serving_frontend.cc,
// built by predictionio_tpu_torch/native/build.py into the port's build
// directory (one library a process per package, so each package's
// frontend has its own g_frontend).  C++ owns the network path and
// AGGREGATES in-flight requests into batches before crossing into Python,
// where one call answers the whole batch (on the card: one launch of the
// top-k kernel at B = batch size):
//
//   worker threads ──► pending queue ──► batcher thread ──► predict callback
//        ▲                                 (≤ max_batch, ≤ max_wait_us)
//        └────────────── per-request response signal ◄─────────┘
//
// Concurrency model: a FIXED pool of worker threads pulls accepted sockets
// from a queue and speaks HTTP/1.1 with keep-alive, so a closed-loop
// client pays connection setup once, not per request.  Shutdown drains
// both queues: queued sockets are closed, queued Pending requests are
// failed with 503 so no worker is left blocked on its condition variable.
//
// The predict callback is registered from Python via ctypes (CFUNCTYPE —
// ctypes acquires the GIL on entry); it receives an opaque batch handle and
// reads/writes requests through the pio_batch_* accessors, so no memory
// crosses allocator boundaries.
//
// Endpoints: GET / (status) and GET /metrics (Prometheus text) are answered
// here unless forward_all is set (event-server mode); EVERY other request
// rides the batcher into the Python callback with "METHOD PATH?QUERY"
// routing metadata (pio_batch_route), so the full engine/event APIs work
// behind this frontend.

#include <arpa/inet.h>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cerrno>
#include <cstring>
#include <deque>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Pending {
  std::string body;
  std::string route;  // "METHOD PATH?QUERY" — routing metadata for Python
  std::string response;
  std::string ctype = "application/json; charset=UTF-8";
  // CRLF-terminated extra header lines a server plugin injected
  // (pio_batch_respond_ex), e.g. "X-Plugin-Count: 5\r\n".
  std::string extra_headers;
  int status = 500;
  bool done = false;
  std::mutex mu;
  std::condition_variable cv;
};

using BatchCb = void (*)(void* batch_handle, int n);

struct Batch {
  std::vector<Pending*> items;
  // Set by pio_batch_respond (same thread: the callback runs synchronously
  // inside this batch's batcher thread).  A responded Pending may be
  // DESTROYED by its worker the moment respond() releases p->mu — the
  // batcher must never touch it again, so doneness lives here, not in p.
  std::vector<char> responded;
};

struct Frontend {
  int listen_fd = -1;
  int port = 0;
  int max_batch = 8;
  int max_wait_us = 2000;
  int n_batchers = 4;
  bool forward_all = false;  // event-server mode: / and /metrics go to Python
  BatchCb cb = nullptr;

  std::atomic<bool> running{false};
  std::thread acceptor;
  // Batcher POOL: each thread forms a batch and drives the Python callback
  // independently, so several batches are in flight at once — parse,
  // predict, and response writes overlap (one batcher with a synchronous
  // callback would serialize the whole server).
  std::vector<std::thread> batchers;
  std::vector<std::thread> workers;

  // accepted sockets awaiting a worker
  std::deque<int> conn_queue;
  std::mutex cmu;
  std::condition_variable ccv;

  // requests awaiting the batcher
  std::deque<Pending*> queue;
  std::mutex qmu;
  std::condition_variable qcv;

  // metrics
  std::atomic<uint64_t> n_requests{0};
  std::atomic<uint64_t> n_errors{0};
  std::atomic<uint64_t> n_batches{0};
  std::atomic<uint64_t> batch_rows{0};
  std::atomic<uint64_t> live_conns{0};
};

Frontend* g_frontend = nullptr;

void write_all(int fd, const char* data, size_t len) {
  size_t off = 0;
  while (off < len) {
    ssize_t w = ::send(fd, data + off, len - off, MSG_NOSIGNAL);
    if (w <= 0) return;
    off += static_cast<size_t>(w);
  }
}

void http_reply(int fd, int status, const char* ctype, const std::string& body,
                bool keep_alive, const std::string& extra_headers = "") {
  const char* reason = status == 200   ? "OK"
                       : status == 201 ? "Created"
                       : status == 400 ? "Bad Request"
                       : status == 401 ? "Unauthorized"
                       : status == 403 ? "Forbidden"
                       : status == 404 ? "Not Found"
                       : status == 500 ? "Internal Server Error"
                       : status == 503 ? "Service Unavailable"
                                       : "Error";
  char head[256];
  int n = snprintf(head, sizeof(head),
                   "HTTP/1.1 %d %s\r\nContent-Type: %s\r\n"
                   "Content-Length: %zu\r\nConnection: %s\r\n",
                   status, reason, ctype, body.size(),
                   keep_alive ? "keep-alive" : "close");
  if (extra_headers.empty()) {
    // hot path: one write for the whole head, no extra syscall
    if (n < (int)sizeof(head) - 2) {
      head[n++] = '\r';
      head[n++] = '\n';
      write_all(fd, head, n);
    } else {
      write_all(fd, head, n);
      write_all(fd, "\r\n", 2);
    }
  } else {
    write_all(fd, head, n);
    write_all(fd, extra_headers.data(), extra_headers.size());
    write_all(fd, "\r\n", 2);
  }
  write_all(fd, body.data(), body.size());
}

// recv that tolerates the 250 ms SO_RCVTIMEO poll while `running`: an idle
// keep-alive connection otherwise pins its worker in a blocking recv and
// pio_frontend_stop joins forever.
ssize_t recv_while_running(int fd, char* buf, size_t len,
                           const std::atomic<bool>& running) {
  for (;;) {
    ssize_t r = ::recv(fd, buf, len, 0);
    if (r >= 0) return r;
    if ((errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) &&
        running.load())
      continue;
    return -1;
  }
}

// Minimal HTTP/1.1 request reader.  `carry` holds bytes of the NEXT
// pipelined/keep-alive request that arrived with a previous read.
bool read_request(int fd, std::string& carry, std::string& method,
                  std::string& path, std::string& body, bool& want_close,
                  const std::atomic<bool>& running) {
  std::string buf;
  buf.swap(carry);
  char tmp[4096];
  size_t header_end = buf.find("\r\n\r\n");
  while (header_end == std::string::npos) {
    ssize_t r = recv_while_running(fd, tmp, sizeof(tmp), running);
    if (r <= 0) return false;
    buf.append(tmp, r);
    header_end = buf.find("\r\n\r\n");
    if (buf.size() > (1u << 20)) return false;  // header flood guard
  }
  const std::string head = buf.substr(0, header_end);
  size_t sp1 = head.find(' ');
  size_t sp2 = head.find(' ', sp1 + 1);
  if (sp1 == std::string::npos || sp2 == std::string::npos) return false;
  method = head.substr(0, sp1);
  path = head.substr(sp1 + 1, sp2 - sp1 - 1);  // query string INCLUDED

  size_t content_length = 0;
  want_close = false;
  bool http10 = head.find("HTTP/1.0") != std::string::npos;
  size_t pos = 0;
  while (pos < head.size()) {
    size_t eol = head.find("\r\n", pos);
    if (eol == std::string::npos) eol = head.size();
    std::string line = head.substr(pos, eol - pos);
    for (auto& c : line)
      if (c >= 'A' && c <= 'Z') c += 32;
    if (line.rfind("content-length:", 0) == 0)
      content_length = strtoul(line.c_str() + 15, nullptr, 10);
    if (line.rfind("connection:", 0) == 0) {
      if (line.find("close") != std::string::npos) want_close = true;
      if (http10 && line.find("keep-alive") != std::string::npos)
        http10 = false;  // explicit keep-alive on 1.0
    }
    pos = eol + 2;
  }
  if (http10) want_close = true;  // HTTP/1.0 default: close
  if (content_length > (64u << 20)) return false;  // 64 MB cap
  body = buf.substr(header_end + 4);
  while (body.size() < content_length) {
    ssize_t r = recv_while_running(fd, tmp, sizeof(tmp), running);
    if (r <= 0) return false;
    body.append(tmp, r);
  }
  if (body.size() > content_length) {
    carry = body.substr(content_length);  // start of the next request
    body.resize(content_length);
  }
  return true;
}

// Serve one request on an open connection.  Returns false when the
// connection should close (error, Connection: close, or shutdown).
bool handle_one(Frontend* fe, int fd, std::string& carry) {
  std::string method, path, body;
  bool want_close = false;
  if (!read_request(fd, carry, method, path, body, want_close, fe->running))
    return false;
  bool keep = !want_close;
  fe->n_requests++;
  std::string bare = path.substr(0, path.find('?'));
  if (!fe->forward_all && method == "GET" && bare == "/") {
    http_reply(fd, 200, "application/json",
               "{\"status\":\"alive\",\"frontend\":\"native\"}", keep);
  } else if (!fe->forward_all && method == "GET" && bare == "/metrics") {
    char m[640];
    uint64_t nb = fe->n_batches.load(), br = fe->batch_rows.load();
    snprintf(m, sizeof(m),
             "# TYPE pio_frontend_requests_total counter\n"
             "pio_frontend_requests_total %llu\n"
             "pio_frontend_errors_total %llu\n"
             "# TYPE pio_frontend_batch_size gauge\n"
             "pio_frontend_batches_total %llu\n"
             "pio_frontend_mean_batch_size %.3f\n"
             "pio_frontend_live_connections %llu\n",
             (unsigned long long)fe->n_requests.load(),
             (unsigned long long)fe->n_errors.load(), (unsigned long long)nb,
             nb ? (double)br / nb : 0.0,
             (unsigned long long)fe->live_conns.load());
    http_reply(fd, 200, "text/plain; version=0.0.4", m, keep);
  } else {
    // Everything else — /queries.json, /events.json, /batch/events.json,
    // webhooks, reload — rides the batcher: concurrent requests aggregate
    // into one Python callback (one GIL entry; the event server turns
    // same-route single-event POSTs into ONE group-committed insert).
    Pending p;
    p.body.swap(body);
    p.route.reserve(method.size() + 1 + path.size());
    p.route.append(method).append(" ").append(path);
    bool queued = false;
    {
      std::lock_guard<std::mutex> lk(fe->qmu);
      // Checked under qmu so shutdown's drain (also under qmu) can never
      // miss a Pending: either we enqueue before the drain, or we observe
      // running == false and 503 immediately.
      if (fe->running.load()) {
        fe->queue.push_back(&p);
        queued = true;
      }
    }
    if (!queued) {
      fe->n_errors++;
      http_reply(fd, 503, "application/json",
                 "{\"message\":\"shutting down\"}", false);
      return false;
    }
    fe->qcv.notify_one();
    {
      std::unique_lock<std::mutex> lk(p.mu);
      p.cv.wait(lk, [&] { return p.done; });
    }
    if (p.status >= 400) fe->n_errors++;
    http_reply(fd, p.status, p.ctype.c_str(), p.response, keep,
               p.extra_headers);
  }
  return keep && fe->running.load();
}

void worker_loop(Frontend* fe) {
  for (;;) {
    int fd = -1;
    {
      std::unique_lock<std::mutex> lk(fe->cmu);
      fe->ccv.wait(lk,
                   [&] { return !fe->conn_queue.empty() || !fe->running; });
      if (fe->conn_queue.empty()) {
        if (!fe->running.load()) return;
        continue;
      }
      fd = fe->conn_queue.front();
      fe->conn_queue.pop_front();
    }
    fe->live_conns++;
    std::string carry;
    while (handle_one(fe, fd, carry)) {
    }
    ::close(fd);
    fe->live_conns--;
  }
}

void batcher_loop(Frontend* fe) {
  while (fe->running.load()) {
    Batch batch;
    {
      std::unique_lock<std::mutex> lk(fe->qmu);
      fe->qcv.wait_for(lk, std::chrono::milliseconds(50),
                       [&] { return !fe->queue.empty() || !fe->running; });
      if (!fe->running.load()) break;
      if (fe->queue.empty()) continue;
      // Continuous batching: take what's there, then linger briefly for
      // stragglers up to max_batch.
      while (!fe->queue.empty() && (int)batch.items.size() < fe->max_batch) {
        batch.items.push_back(fe->queue.front());
        fe->queue.pop_front();
      }
      // Adaptive linger: wait for stragglers only when some OTHER live
      // connection could still contribute one.  Each connection has at
      // most one request in flight (handle_one is sequential per
      // connection), so with live_conns <= batch size every live client
      // is already parked in THIS batch and the linger could only burn
      // its own latency on an idle server.
      if ((int)batch.items.size() < fe->max_batch && fe->max_wait_us > 0 &&
          fe->live_conns.load() > batch.items.size()) {
        auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::microseconds(fe->max_wait_us);
        while ((int)batch.items.size() < fe->max_batch &&
               fe->qcv.wait_until(lk, deadline,
                                  [&] { return !fe->queue.empty(); })) {
          while (!fe->queue.empty() &&
                 (int)batch.items.size() < fe->max_batch) {
            batch.items.push_back(fe->queue.front());
            fe->queue.pop_front();
          }
        }
      }
    }
    fe->n_batches++;
    fe->batch_rows += batch.items.size();
    batch.responded.assign(batch.items.size(), 0);
    if (fe->cb) {
      fe->cb(&batch, (int)batch.items.size());  // → Python (GIL via ctypes)
    }
    // Only UNRESPONDED items may be touched here (their workers are still
    // parked on p->cv; responded Pendings may already be destroyed).
    for (size_t i = 0; i < batch.items.size(); i++) {
      if (batch.responded[i]) continue;
      Pending* p = batch.items[i];
      std::lock_guard<std::mutex> lk(p->mu);
      p->status = 500;
      p->response = "{\"message\":\"no response produced\"}";
      p->done = true;
      p->cv.notify_one();
    }
  }
}

// Shutdown drain (called once after ALL batchers joined): anything still
// queued gets a definite answer so its worker never blocks on p->cv.
void drain_queue(Frontend* fe) {
  std::deque<Pending*> rest;
  {
    std::lock_guard<std::mutex> lk(fe->qmu);
    rest.swap(fe->queue);
  }
  for (Pending* p : rest) {
    std::lock_guard<std::mutex> lk(p->mu);
    p->status = 503;
    p->response = "{\"message\":\"shutting down\"}";
    p->done = true;
    p->cv.notify_one();
  }
}

void acceptor_loop(Frontend* fe) {
  while (fe->running.load()) {
    sockaddr_in peer;
    socklen_t plen = sizeof(peer);
    int fd = ::accept(fe->listen_fd, (sockaddr*)&peer, &plen);
    if (fd < 0) {
      if (!fe->running.load()) break;
      continue;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // Bounded recv so workers re-check `running` while a keep-alive
    // connection idles (shutdown liveness, not a request deadline).
    timeval tv{0, 250 * 1000};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    {
      std::lock_guard<std::mutex> lk(fe->cmu);
      fe->conn_queue.push_back(fd);
    }
    fe->ccv.notify_one();
  }
}

}  // namespace

extern "C" {

int pio_frontend_start(const char* host, int port, int max_batch,
                       int max_wait_us, int n_batchers, int forward_all,
                       BatchCb cb) {
  if (g_frontend) return -1;
  auto* fe = new Frontend();
  fe->forward_all = forward_all != 0;
  fe->max_batch = max_batch > 0 ? max_batch : 8;
  fe->max_wait_us = max_wait_us;
  fe->n_batchers = n_batchers > 0 ? n_batchers : 4;
  fe->cb = cb;
  fe->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fe->listen_fd < 0) {
    delete fe;
    return -2;
  }
  int one = 1;
  setsockopt(fe->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  addr.sin_addr.s_addr = host && *host ? inet_addr(host) : INADDR_ANY;
  if (bind(fe->listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(fe->listen_fd, 512) != 0) {
    ::close(fe->listen_fd);
    delete fe;
    return -3;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fe->listen_fd, (sockaddr*)&addr, &alen);
  fe->port = ntohs(addr.sin_port);
  fe->running = true;
  // Worker pool bounds concurrent in-flight requests; sized past max_batch
  // so the batcher can actually fill a batch from concurrent clients.
  unsigned hw = std::thread::hardware_concurrency();
  int n_workers = (int)(hw ? hw * 4 : 16);
  if (n_workers < fe->max_batch) n_workers = fe->max_batch;
  if (n_workers > 128) n_workers = 128;
  fe->workers.reserve(n_workers);
  for (int i = 0; i < n_workers; i++)
    fe->workers.emplace_back(worker_loop, fe);
  fe->batchers.reserve(fe->n_batchers);
  for (int i = 0; i < fe->n_batchers; i++)
    fe->batchers.emplace_back(batcher_loop, fe);
  fe->acceptor = std::thread(acceptor_loop, fe);
  g_frontend = fe;
  return fe->port;
}

int pio_frontend_port() { return g_frontend ? g_frontend->port : -1; }

const char* pio_batch_request(void* batch_handle, int i, int* len_out) {
  auto* b = static_cast<Batch*>(batch_handle);
  if (i < 0 || i >= (int)b->items.size()) return nullptr;
  if (len_out) *len_out = (int)b->items[i]->body.size();
  return b->items[i]->body.c_str();
}

const char* pio_batch_route(void* batch_handle, int i, int* len_out) {
  // "METHOD PATH?QUERY" for item i — lets the Python callback dispatch
  // beyond /queries.json (event ingest, webhooks, reload).
  auto* b = static_cast<Batch*>(batch_handle);
  if (i < 0 || i >= (int)b->items.size()) return nullptr;
  if (len_out) *len_out = (int)b->items[i]->route.size();
  return b->items[i]->route.c_str();
}

// Respond with plugin-injected extra header lines (server plugin seam,
// reference: EngineServerPlugin/EventServerPlugin request instrumentation).
// `extra_headers` is zero or more "Name: value" lines joined with CRLF;
// a trailing CRLF is appended if missing.  Lines containing header
// injection (bare CR/LF inside a value) are the CALLER's responsibility
// to sanitize (the Python seam does).
void pio_batch_respond_ex(void* batch_handle, int i, const char* data,
                          int len, int status, const char* ctype,
                          const char* extra_headers) {
  auto* b = static_cast<Batch*>(batch_handle);
  if (i < 0 || i >= (int)b->items.size()) return;
  Pending* p = b->items[i];
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->response.assign(data, len);
    if (ctype && *ctype) p->ctype = ctype;
    if (extra_headers && *extra_headers) {
      p->extra_headers = extra_headers;
      if (p->extra_headers.size() < 2 ||
          p->extra_headers.compare(p->extra_headers.size() - 2, 2,
                                   "\r\n") != 0)
        p->extra_headers += "\r\n";
    }
    p->status = status;
    p->done = true;
    p->cv.notify_one();  // under p->mu: p may be destroyed once we release
  }
  b->responded[i] = 1;  // same thread as the batcher loop — no lock needed
}

void pio_batch_respond(void* batch_handle, int i, const char* data, int len,
                       int status, const char* ctype) {
  pio_batch_respond_ex(batch_handle, i, data, len, status, ctype, nullptr);
}

void pio_frontend_stop() {
  Frontend* fe = g_frontend;
  if (!fe) return;
  fe->running = false;
  ::shutdown(fe->listen_fd, SHUT_RDWR);
  ::close(fe->listen_fd);
  fe->qcv.notify_all();  // wake every batcher
  if (fe->acceptor.joinable()) fe->acceptor.join();
  for (auto& t : fe->batchers)
    if (t.joinable()) t.join();
  drain_queue(fe);  // after ALL batchers are gone: 503 any leftovers
  // Close sockets no worker picked up, then release the pool.
  {
    std::lock_guard<std::mutex> lk(fe->cmu);
    for (int fd : fe->conn_queue) ::close(fd);
    fe->conn_queue.clear();
  }
  fe->ccv.notify_all();
  for (auto& t : fe->workers)
    if (t.joinable()) t.join();
  g_frontend = nullptr;
  delete fe;
}

}  // extern "C"
