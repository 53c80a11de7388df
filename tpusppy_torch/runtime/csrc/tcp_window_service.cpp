// TCP window service: versioned mailboxes for cross-HOST cylinder exchange.
//
// The port's own copy of tpusppy/runtime/csrc/tcp_window_service.cpp (the
// wire protocol and the C ABI are the reference's), built with g++ into
// tpusppy_torch/_build/ by tpusppy_torch/runtime/tcp_window_service.py.
//
// The multi-host sibling of the shared-memory seqlock service
// (window_service.cpp).  The reference's wheel spans 256 nodes / 4000 ranks
// over one-sided MPI RMA (mpisppy/spin_the_wheel.py:219-237,
// cylinders/spcommunicator.py:93-120); here the hub process runs a tiny
// in-memory box server and every spoke — on this host or another — speaks a
// fixed-frame binary protocol over TCP.  Semantics are IDENTICAL to the shm
// service and to the in-process Mailbox: monotone write_id per box, kill
// sentinel write_id == -1 (terminal), length-checked puts/gets, consistent
// snapshots (mutex per box here; seqlock in shm).
//
// Protocol (little-endian, one request in flight per connection):
//   hello    { u64 magic; u64 secret; } -> { i64 0 } ack, or closed on
//            mismatch (shared-secret handshake; the hub hands the secret to
//            its spokes out-of-band, e.g. on the spawn command line)
//   request  { u8 op; u8 pad[3]; i32 box; i64 n; }   [+ n doubles for PUT]
//   reply    { i64 id; }                              [+ n doubles for GET]
//   ops: 1=PUT 2=GET 3=WRITE_ID 4=KILL 5=INFO
//   INFO reply: id = n_boxes, followed by n_boxes i64 lengths.
//   id == -2 signals a length mismatch (no payload follows).
// Requests with n above the largest configured box length close the
// connection (no attacker-sized scratch allocations).  The server binds
// 127.0.0.1 unless an explicit bind address is supplied.
//
// C ABI mirrors ws_*: tws_serve / tws_connect / tws_put / tws_get /
// tws_write_id / tws_kill / tws_port / tws_num_boxes / tws_length /
// tws_close.  A server handle also serves LOCAL (in-process) operations for
// the hub side — same mutexes, no sockets.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <sys/time.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>   // std::snprintf (not pulled in by the other headers on GCC 13)
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kKillId = -1;
constexpr int64_t kLenErr = -2;
constexpr int64_t kIoErr = -4;
constexpr int64_t kTimeoutErr = -5;
constexpr uint64_t kMagic = 0x7470757370707931ULL;  // "tpusppy1"

// Every socket is close-on-exec: an elastic re-mesh replaces the process
// image with execve (tpusppy/parallel/elastic.py), and a leaked listen fd
// would keep the port bound forever — the re-exec'd process could never
// re-serve its liveness/fabric endpoint.
void set_cloexec(int fd) { fcntl(fd, F_SETFD, FD_CLOEXEC); }

struct Request {
  uint8_t op;
  uint8_t pad[3];
  int32_t box;
  int64_t n;
};

struct Hello {
  uint64_t magic;
  uint64_t secret;
};

struct Box {
  std::mutex mu;
  int64_t write_id = 0;
  std::vector<double> payload;
};

struct Conn {
  std::thread th;
  int fd = -1;
  std::atomic<bool> done{false};
};

struct Server {
  int listen_fd = -1;
  uint16_t port = 0;
  std::atomic<bool> stop{false};
  std::thread accept_thread;
  std::mutex conn_mu;
  // finished connections (rejected handshakes, disconnected spokes) are
  // reaped on the next accept, so hostile probing cannot grow this
  std::vector<std::unique_ptr<Conn>> conns;
  std::vector<Box> boxes;
  uint64_t secret = 0;
  int64_t max_len = 0;  // largest configured box; caps request n
};

struct Handle {
  Server* server = nullptr;  // set for the hub-side handle
  int sock = -1;             // set for client handles
  std::mutex io_mu;          // one request in flight per client
  int64_t op_timeout_ms = 0;  // 0 = block forever (legacy behavior)
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

int64_t local_put(Box& b, const double* values, int64_t n) {
  std::lock_guard<std::mutex> lock(b.mu);
  if (n != static_cast<int64_t>(b.payload.size())) return kLenErr;
  if (b.write_id == kKillId) return kKillId;  // terminal, as in shm/Mailbox
  std::memcpy(b.payload.data(), values, n * sizeof(double));
  return ++b.write_id;
}

int64_t local_get(Box& b, double* out, int64_t n) {
  std::lock_guard<std::mutex> lock(b.mu);
  if (n != static_cast<int64_t>(b.payload.size())) return kLenErr;
  std::memcpy(out, b.payload.data(), n * sizeof(double));
  return b.write_id;
}

void serve_connection(Server* s, Conn* conn) {
  const int fd = conn->fd;
  struct MarkDone {
    Conn* c;
    ~MarkDone() { c->done.store(true, std::memory_order_release); }
  } mark{conn};
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // shared-secret handshake before any request is honored; the hello read
  // is time-bounded so a half-open probe cannot pin this thread (and its
  // Conn slot) forever — after the timeout the reap loop frees it
  timeval tv{10, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  Hello hello{};
  if (!read_full(fd, &hello, sizeof(hello)) || hello.magic != kMagic ||
      hello.secret != s->secret) {
    close(fd);
    return;
  }
  int64_t ack = 0;
  if (!write_full(fd, &ack, sizeof(ack))) { close(fd); return; }
  timeval off{0, 0};  // authenticated: back to blocking reads
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
  std::vector<double> scratch;
  Request req;
  while (!s->stop.load(std::memory_order_relaxed)) {
    if (!read_full(fd, &req, sizeof(req))) break;
    const bool box_ok =
        req.box >= 0 && req.box < static_cast<int32_t>(s->boxes.size());
    int64_t id = kLenErr;
    switch (req.op) {
      case 1: {  // PUT: payload follows regardless; must be drained
        if (req.n < 0 || req.n > s->max_len) { close(fd); return; }
        scratch.resize(static_cast<size_t>(req.n));
        if (!read_full(fd, scratch.data(), req.n * sizeof(double))) {
          close(fd);
          return;
        }
        if (box_ok) id = local_put(s->boxes[req.box], scratch.data(), req.n);
        if (!write_full(fd, &id, sizeof(id))) { close(fd); return; }
        break;
      }
      case 2: {  // GET
        if (req.n < 0 || req.n > s->max_len) { close(fd); return; }
        scratch.resize(box_ok ? static_cast<size_t>(req.n) : 0);
        if (box_ok) id = local_get(s->boxes[req.box], scratch.data(), req.n);
        if (!write_full(fd, &id, sizeof(id))) { close(fd); return; }
        if (id != kLenErr &&
            !write_full(fd, scratch.data(), req.n * sizeof(double))) {
          close(fd);
          return;
        }
        break;
      }
      case 3: {  // WRITE_ID
        if (box_ok) {
          std::lock_guard<std::mutex> lock(s->boxes[req.box].mu);
          id = s->boxes[req.box].write_id;
        }
        if (!write_full(fd, &id, sizeof(id))) { close(fd); return; }
        break;
      }
      case 4: {  // KILL
        if (box_ok) {
          std::lock_guard<std::mutex> lock(s->boxes[req.box].mu);
          s->boxes[req.box].write_id = kKillId;
          id = kKillId;
        }
        if (!write_full(fd, &id, sizeof(id))) { close(fd); return; }
        break;
      }
      case 5: {  // INFO
        id = static_cast<int64_t>(s->boxes.size());
        if (!write_full(fd, &id, sizeof(id))) { close(fd); return; }
        std::vector<int64_t> lens(s->boxes.size());
        for (size_t i = 0; i < s->boxes.size(); ++i)
          lens[i] = static_cast<int64_t>(s->boxes[i].payload.size());
        if (!write_full(fd, lens.data(), lens.size() * sizeof(int64_t))) {
          close(fd);
          return;
        }
        break;
      }
      default:
        close(fd);
        return;
    }
  }
  close(fd);
}

void accept_loop(Server* s) {
  while (!s->stop.load(std::memory_order_relaxed)) {
    sockaddr_in peer;
    socklen_t plen = sizeof(peer);
    int fd = accept(s->listen_fd, reinterpret_cast<sockaddr*>(&peer), &plen);
    if (fd < 0) {
      if (s->stop.load(std::memory_order_relaxed)) return;
      if (errno == EINTR) continue;
      return;  // listener closed
    }
    set_cloexec(fd);
    std::lock_guard<std::mutex> lock(s->conn_mu);
    // reap finished connections before tracking the new one
    for (auto it = s->conns.begin(); it != s->conns.end();) {
      if ((*it)->done.load(std::memory_order_acquire)) {
        if ((*it)->th.joinable()) (*it)->th.join();
        it = s->conns.erase(it);
      } else {
        ++it;
      }
    }
    auto conn = std::make_unique<Conn>();
    conn->fd = fd;
    conn->th = std::thread(serve_connection, s, conn.get());
    s->conns.push_back(std::move(conn));
  }
}

}  // namespace

extern "C" {

// Start a box server on `port` (0 = kernel-assigned; read back via
// tws_port).  Binds `bind_addr` — 127.0.0.1 when null/empty; pass
// "0.0.0.0" EXPLICITLY to accept spokes from other hosts (the handshake
// secret still gates every connection).
void* tws_serve(const char* bind_addr, int port, int n_boxes,
                const int64_t* lengths, uint64_t secret) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  set_cloexec(fd);
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  const char* baddr =
      (bind_addr && bind_addr[0]) ? bind_addr : "127.0.0.1";
  if (inet_pton(AF_INET, baddr, &addr.sin_addr) != 1) {
    close(fd);
    return nullptr;
  }
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 64) != 0) {
    close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);

  auto* s = new Server();
  s->listen_fd = fd;
  s->port = ntohs(addr.sin_port);
  s->secret = secret;
  s->boxes = std::vector<Box>(static_cast<size_t>(n_boxes));
  for (int i = 0; i < n_boxes; ++i) {
    s->boxes[i].payload.assign(static_cast<size_t>(lengths[i]), 0.0);
    if (lengths[i] > s->max_len) s->max_len = lengths[i];
  }
  s->accept_thread = std::thread(accept_loop, s);
  auto* h = new Handle();
  h->server = s;
  return h;
}

// Connect to a server, retrying for up to timeout_ms (spokes may start
// before the hub finishes binding).  Sends the shared-secret hello and
// waits for the ack; a secret mismatch fails immediately (server closes).
void* tws_connect(const char* host, int port, int64_t timeout_ms,
                  uint64_t secret) {
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  std::snprintf(portstr, sizeof(portstr), "%d", port);
  for (int64_t waited = 0;;) {
    addrinfo* res = nullptr;
    if (getaddrinfo(host, portstr, &hints, &res) == 0 && res != nullptr) {
      int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
      if (fd >= 0) set_cloexec(fd);
      if (fd >= 0 &&
          connect(fd, res->ai_addr, static_cast<socklen_t>(res->ai_addrlen))
              == 0) {
        freeaddrinfo(res);
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        // the handshake itself is bounded by the remaining budget (a
        // non-tpusppy listener would otherwise hang the ack read forever)
        int64_t left = timeout_ms - waited;
        if (left < 1000) left = 1000;
        timeval tv{static_cast<time_t>(left / 1000),
                   static_cast<suseconds_t>((left % 1000) * 1000)};
        setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
        setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
        Hello hello{kMagic, secret};
        int64_t ack = -1;
        if (!write_full(fd, &hello, sizeof(hello)) ||
            !read_full(fd, &ack, sizeof(ack)) || ack != 0) {
          close(fd);
          return nullptr;  // bad secret / not our service; don't retry
        }
        timeval off{0, 0};  // back to blocking for normal operation
        setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
        setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &off, sizeof(off));
        auto* h = new Handle();
        h->sock = fd;
        return h;
      }
      if (fd >= 0) close(fd);
      freeaddrinfo(res);
    }
    if (waited >= timeout_ms) return nullptr;
    usleep(100000);  // 100 ms
    waited += 100;
  }
}

int tws_port(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  return h->server ? h->server->port : -1;
}

// Per-op deadline for CLIENT handles (ms; 0 restores blocking forever).
// After the deadline an op returns kTimeoutErr and the connection is
// closed (frame desync) — the caller must reconnect.  Server handles are
// local mutexed memory: the deadline is meaningless there (no-op).
int tws_set_op_timeout(void* handle, int64_t timeout_ms) {
  auto* h = static_cast<Handle*>(handle);
  if (h->server) return 0;
  h->op_timeout_ms = timeout_ms < 0 ? 0 : timeout_ms;
  if (h->sock < 0) return -1;
  timeval tv{static_cast<time_t>(h->op_timeout_ms / 1000),
             static_cast<suseconds_t>((h->op_timeout_ms % 1000) * 1000)};
  setsockopt(h->sock, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(h->sock, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  return 0;
}

// One client op failed mid-frame: the connection is out of sync (a late
// reply to the timed-out request would be parsed as the NEXT op's reply),
// so it is closed and invalidated here, never reused.  EAGAIN/EWOULDBLOCK
// means the op deadline (tws_set_op_timeout) expired on a connected-but-
// unresponsive server — the wedged-server case a plain IO error can't
// name — and is reported distinctly as kTimeoutErr.
static int64_t client_fail(Handle* h) {
  // gate the timeout classification on an ARMED deadline: an orderly
  // server close (recv()==0) leaves errno untouched, so a stale EAGAIN
  // from unrelated earlier I/O must not masquerade as "op timed out"
  const bool timed_out = h->op_timeout_ms > 0 &&
                         (errno == EAGAIN || errno == EWOULDBLOCK);
  close(h->sock);
  h->sock = -1;
  return timed_out ? kTimeoutErr : kIoErr;
}

static int64_t request_reply(Handle* h, uint8_t op, int box, int64_t n,
                             const double* in, double* out) {
  std::lock_guard<std::mutex> lock(h->io_mu);
  if (h->sock < 0) return kIoErr;
  Request req{};
  req.op = op;
  req.box = box;
  req.n = n;
  if (!write_full(h->sock, &req, sizeof(req))) return client_fail(h);
  if (op == 1 && n > 0 &&
      !write_full(h->sock, in, n * sizeof(double)))
    return client_fail(h);
  int64_t id;
  if (!read_full(h->sock, &id, sizeof(id))) return client_fail(h);
  if (op == 2 && id != kLenErr &&
      !read_full(h->sock, out, n * sizeof(double)))
    return client_fail(h);
  return id;
}

// Client-side INFO: the reply is the box count followed by ALL lengths,
// which must be fully drained to keep the connection framed.
static int64_t client_info(Handle* h, std::vector<int64_t>* lens_out) {
  std::lock_guard<std::mutex> lock(h->io_mu);
  if (h->sock < 0) return kIoErr;
  Request req{};
  req.op = 5;
  if (!write_full(h->sock, &req, sizeof(req))) return client_fail(h);
  int64_t nb;
  if (!read_full(h->sock, &nb, sizeof(nb))) return client_fail(h);
  std::vector<int64_t> lens(static_cast<size_t>(nb));
  if (!read_full(h->sock, lens.data(), lens.size() * sizeof(int64_t)))
    return client_fail(h);
  if (lens_out) *lens_out = std::move(lens);
  return nb;
}

int64_t tws_num_boxes(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  if (h->server) return static_cast<int64_t>(h->server->boxes.size());
  return client_info(h, nullptr);
}

int64_t tws_length(void* handle, int box) {
  auto* h = static_cast<Handle*>(handle);
  if (h->server) {
    if (box < 0 || box >= static_cast<int>(h->server->boxes.size()))
      return kLenErr;
    return static_cast<int64_t>(h->server->boxes[box].payload.size());
  }
  std::vector<int64_t> lens;
  int64_t nb = client_info(h, &lens);
  if (nb < 0) return nb;
  if (box < 0 || box >= nb) return kLenErr;
  return lens[static_cast<size_t>(box)];
}

// The hub-local (server-handle) branches apply the same box-range check as
// the socket path (box_ok): out-of-range ids report kLenErr, never UB.
static bool server_box_ok(const Server* s, int box) {
  return box >= 0 && box < static_cast<int>(s->boxes.size());
}

int64_t tws_put(void* handle, int box, const double* values, int64_t n) {
  auto* h = static_cast<Handle*>(handle);
  if (h->server) {
    if (!server_box_ok(h->server, box)) return kLenErr;
    return local_put(h->server->boxes[box], values, n);
  }
  return request_reply(h, 1, box, n, values, nullptr);
}

int64_t tws_get(void* handle, int box, double* out, int64_t n) {
  auto* h = static_cast<Handle*>(handle);
  if (h->server) {
    if (!server_box_ok(h->server, box)) return kLenErr;
    return local_get(h->server->boxes[box], out, n);
  }
  return request_reply(h, 2, box, n, nullptr, out);
}

int64_t tws_write_id(void* handle, int box) {
  auto* h = static_cast<Handle*>(handle);
  if (h->server) {
    if (!server_box_ok(h->server, box)) return kLenErr;
    std::lock_guard<std::mutex> lock(h->server->boxes[box].mu);
    return h->server->boxes[box].write_id;
  }
  return request_reply(h, 3, box, 0, nullptr, nullptr);
}

int64_t tws_kill(void* handle, int box) {
  auto* h = static_cast<Handle*>(handle);
  if (h->server) {
    if (!server_box_ok(h->server, box)) return kLenErr;
    std::lock_guard<std::mutex> lock(h->server->boxes[box].mu);
    h->server->boxes[box].write_id = kKillId;
    return kKillId;
  }
  return request_reply(h, 4, box, 0, nullptr, nullptr);
}

void tws_close(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  if (h->server) {
    Server* s = h->server;
    s->stop.store(true, std::memory_order_relaxed);
    shutdown(s->listen_fd, SHUT_RDWR);
    close(s->listen_fd);
    if (s->accept_thread.joinable()) s->accept_thread.join();
    {
      // unblock every handler (recv returns 0 after shutdown), then JOIN:
      // detaching would let a late request dereference the freed Server
      std::lock_guard<std::mutex> lock(s->conn_mu);
      for (auto& c : s->conns) shutdown(c->fd, SHUT_RDWR);
    }
    for (auto& c : s->conns)
      if (c->th.joinable()) c->th.join();
    delete s;
  } else if (h->sock >= 0) {
    close(h->sock);
  }
  delete h;
}

}  // extern "C"
