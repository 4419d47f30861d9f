// Native socket data plane for the multi-stream detection server.
//
// The Python serving daemon (serve/server.py) spends its per-frame time in
// the interpreter: parsing AUDIO frames, assembling the (S, chunk) tick
// batch and routing events all contend with the tick and fetch threads
// for the GIL. This plane moves the ENTIRE socket tier — accept, framing,
// slot allocation, per-slot ring buffers, event encoding/writeback —
// into N epoll worker threads with no Python in the per-frame path
// (default N=1; connections partition across workers round-robin at
// accept, see struct Worker — the horizontal scaling path for hosts
// where frame parsing outruns one core). Python keeps the device plane:
// per tick it calls cdt_ingest_assemble() (one memcpy-per-slot fill of
// the batch), enqueues the device tick, and hands detections back via
// cdt_ingest_send_events().
//
// Wire protocol: normative spec in docs/PROTOCOL.md (frame table, byte
// layouts, generation semantics, backpressure rules); byte-identical to
// serve/protocol.py, which tests/test_protocol_doc.py conformance-checks
// against the doc's examples —
//   header <HBBII> little-endian: magic 0x0CD7, type u8, flags u8,
//   stream u32, length u32; AUDIO payload f32le PCM; EVENT payload
//   UTF-8 JSON {"time": s, "confidence": p}; ERROR payload UTF-8 text.
//
// Isolation semantics mirror the Python backend exactly:
//   * a granted slot stays PENDING (assemble zero-fills it) until the
//     control plane acknowledges it via cdt_ingest_granted() and scrubs
//     the device-side lane — a new tenant's audio is never scored
//     through the previous tenant's ring/history/debounce state;
//   * slot reuse bumps a generation; events carrying a stale generation
//     are dropped, never cross-delivered;
//   * per-slot buffers are bounded, overflow drops OLDEST and counts;
//   * per-connection outboxes are bounded, events to a stalled client
//     are dropped and counted — one slow client never blocks the tick;
//   * protocol violations get a best-effort ERROR, then only that
//     connection dies.
//
// Build: g++ -O3 -fPIC -shared -pthread -std=c++17 (see
// serve/native_ingest.py; same on-demand pattern as cdt_loader.cpp).

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <limits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <memory>
#include <string>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint16_t kMagic = 0x0CD7;
constexpr int kHeaderSize = 12;
constexpr uint32_t kMaxPayload = 16u << 20;
constexpr size_t kOutboxCap = 4u << 20;  // bytes per connection

enum FrameType : uint8_t {
  OPEN = 1, OPENED = 2, AUDIO = 3, EVENT = 4, CLOSE = 5, ERR = 6,
  THRESH = 7,  // set the slot's confidence threshold mid-stream
};

struct Conn;

struct Slot {
  std::mutex m;
  std::vector<float> ring;   // capacity buffer_cap samples
  size_t rd = 0, wr = 0;     // absolute sample counters (rd <= wr)
  Conn* owner = nullptr;
  uint32_t gen = 0;          // bumped per grant
  bool open = false;
  bool pending = false;      // granted but not yet scrubbed by control
};

struct Grant {
  int sid;
  uint32_t gen;
  float threshold;  // per-stream confidence threshold; NaN = server default
};

struct Conn {
  int fd = -1;
  int worker = 0;            // owning I/O thread; all input parsing,
                             // reaping and epoll rearming for this
                             // connection happen on that thread only
  std::vector<uint8_t> inbuf;
  // Outbox: contiguous bytes [out_head, outbox.size()) are unsent.
  // A vector + head offset keeps flushes single-send() / single-memcpy
  // (a byte deque walked per element cost real time on the one-core
  // host that is this daemon's measured ceiling).
  std::vector<uint8_t> outbox;
  size_t out_head = 0;
  std::mutex out_m;
  std::vector<int> slots;    // owned slot ids
  bool dead = false;         // marked for reaping (io loop collects)
  bool reaped = false;       // already on this batch's reap list
  bool closed = false;       // cleanup done (close_conn ran)
};

struct Header {
  uint8_t type;
  uint32_t stream;
  uint32_t length;
};

// One I/O thread's epoll machinery. Workers partition CONNECTIONS (the
// epoll entities), not slots: a connection's input parsing, frame
// handling, flushing and reaping all run on its owning worker, so the
// per-conn state (inbuf, dead/reaped/closed) stays single-threaded with
// no new locks; the slot registry was already mutex-guarded for the
// control plane, so cross-worker slot traffic needs nothing new and
// assemble() merges all slots unchanged. Default 1 worker is a single
// epoll plane; N workers is the horizontal path for a multi-core host
// where frame parsing outruns one core.
struct Worker {
  int epoll_fd = -1;
  int wake_fd = -1;          // eventfd: router wants a flush / stop
  std::thread th;
};

struct Server {
  int listen_fd = -1;
  int port = 0;
  int num_streams = 0;
  int chunk = 0;
  long buffer_cap = 0;

  std::vector<Worker> workers;        // sized once before threads start
  std::atomic<uint32_t> rr{0};        // round-robin accept assignment
  // Written by the control thread (cdt_ingest_stop), read by the epoll
  // threads — must be atomic for a defined happens-before edge.
  std::atomic<bool> stopping{false};

  std::mutex reg_m;          // slots' registry fields, free list, conns
  std::vector<std::unique_ptr<Slot>> slots;
  std::vector<int> free_slots;
  std::vector<Grant> granted;  // since last fetch
  // Mid-stream THRESH retunes since the last drain (reg_m): the control
  // plane applies them scrub-free after any grants the same tick.
  std::vector<std::pair<int, float>> thr_updates;
  std::unordered_map<int, Conn*> conns;           // fd -> conn

  // stats (reg_m)
  long long st_connections = 0, st_refused = 0, st_dropped_samples = 0,
            st_events = 0, st_events_dropped = 0;
};

void set_err(char* errbuf, int errlen, const char* msg) {
  if (errbuf && errlen > 0) {
    std::snprintf(errbuf, (size_t)errlen, "%s", msg);
  }
}

bool set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  return fl >= 0 && fcntl(fd, F_SETFL, fl | O_NONBLOCK) == 0;
}

void enqueue_bytes(Server* s, Conn* c, const uint8_t* data, size_t n,
                   bool* dropped) {
  std::lock_guard<std::mutex> lk(c->out_m);
  if ((c->outbox.size() - c->out_head) + n > kOutboxCap) {
    if (dropped) *dropped = true;
    return;
  }
  // Compact before growing if the sent prefix dominates the buffer —
  // keeps steady-state memory ~the unsent bytes without a per-flush
  // erase.
  if (c->out_head > 4096 && c->out_head * 2 >= c->outbox.size()) {
    c->outbox.erase(c->outbox.begin(),
                    c->outbox.begin() + (long)c->out_head);
    c->out_head = 0;
  }
  c->outbox.insert(c->outbox.end(), data, data + n);
  if (dropped) *dropped = false;
}

void make_header(uint8_t* out, uint8_t type, uint32_t stream,
                 uint32_t length) {
  out[0] = (uint8_t)(kMagic & 0xff);
  out[1] = (uint8_t)(kMagic >> 8);
  out[2] = type;
  out[3] = 0;
  std::memcpy(out + 4, &stream, 4);   // x86: little-endian already
  std::memcpy(out + 8, &length, 4);
}

void send_frame(Server* s, Conn* c, uint8_t type, uint32_t stream,
                const uint8_t* payload, uint32_t len, bool* dropped) {
  std::vector<uint8_t> buf(kHeaderSize + len);
  make_header(buf.data(), type, stream, len);
  if (len) std::memcpy(buf.data() + kHeaderSize, payload, len);
  enqueue_bytes(s, c, buf.data(), buf.size(), dropped);
}

// reg_m held.
void release_slot_locked(Server* s, int sid, Conn* c) {
  {
    Slot& sl = *s->slots[sid];
    std::lock_guard<std::mutex> lk(sl.m);
    if (!sl.open || sl.owner != c) return;
    sl.open = false;
    sl.pending = false;
    sl.owner = nullptr;
    sl.rd = sl.wr = 0;
  }
  s->free_slots.push_back(sid);
  // Cross-tenant isolation: pending control-plane work for this slot
  // belongs to the departing tenant. A queued grant or THRESH retune
  // that outlived its sender must never apply to the slot's NEXT
  // tenant (and purging here also bounds both queues at num_streams —
  // a slot can re-enter them only after a release purged it).
  for (auto it = s->granted.begin(); it != s->granted.end();) {
    it = (it->sid == sid) ? s->granted.erase(it) : it + 1;
  }
  for (auto it = s->thr_updates.begin(); it != s->thr_updates.end();) {
    it = (it->first == sid) ? s->thr_updates.erase(it) : it + 1;
  }
}

// epoll thread only. Callers mark c->dead to request reaping; the
// `closed` flag (not `dead`) guards double-cleanup — reap lists can
// carry the same connection twice in one epoll batch.
void close_conn(Server* s, Conn* c) {
  if (c->closed) return;
  c->closed = true;
  c->dead = true;
  {
    std::lock_guard<std::mutex> lk(s->reg_m);
    for (int sid : c->slots) release_slot_locked(s, sid, c);
    c->slots.clear();
    s->conns.erase(c->fd);
  }
  epoll_ctl(s->workers[c->worker].epoll_fd, EPOLL_CTL_DEL, c->fd,
            nullptr);
  ::close(c->fd);
  delete c;  // safe: send_events reaches conns only under reg_m
}

void flush_conn(Server* s, Conn* c) {
  std::lock_guard<std::mutex> lk(c->out_m);
  while (c->out_head < c->outbox.size()) {
    size_t n = c->outbox.size() - c->out_head;
    ssize_t w = ::send(c->fd, c->outbox.data() + c->out_head, n,
                       MSG_NOSIGNAL);
    if (w > 0) {
      c->out_head += (size_t)w;
      if ((size_t)w < n) break;  // kernel buffer full
    } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      break;
    } else {
      c->dead = true;  // real error; reaped by caller
      return;
    }
  }
  if (c->out_head == c->outbox.size()) {
    c->outbox.clear();
    c->out_head = 0;
  }
}

void rearm(Server* s, Conn* c) {
  bool pending_out;
  {
    std::lock_guard<std::mutex> lk(c->out_m);
    pending_out = c->out_head < c->outbox.size();
  }
  epoll_event ev{};
  ev.events = EPOLLIN | (pending_out ? EPOLLOUT : 0);
  ev.data.ptr = c;
  epoll_ctl(s->workers[c->worker].epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
}

void protocol_error(Server* s, Conn* c, const char* msg) {
  bool dropped;
  send_frame(s, c, ERR, 0, (const uint8_t*)msg, (uint32_t)strlen(msg),
             &dropped);
  flush_conn(s, c);  // best effort before the connection dies
  c->dead = true;
}

void handle_frame(Server* s, Conn* c, const Header& h,
                  const uint8_t* payload) {
  switch (h.type) {
    case OPEN: {
      // Empty payload = server-default sensitivity; exactly 4 bytes =
      // this stream's own float32le confidence threshold (multi-tenant
      // serving; mirrors serve/protocol.py encode_open).
      float threshold = std::numeric_limits<float>::quiet_NaN();
      if (h.length == 4) {
        std::memcpy(&threshold, payload, 4);
        if (!std::isfinite(threshold)) {
          protocol_error(s, c, "OPEN threshold must be finite");
          return;
        }
      } else if (h.length != 0) {
        protocol_error(s, c, "OPEN payload must be empty or 4 bytes");
        return;
      }
      int sid = -1;
      uint32_t gen = 0;
      {
        std::lock_guard<std::mutex> lk(s->reg_m);
        if (!s->free_slots.empty()) {
          sid = s->free_slots.back();
          s->free_slots.pop_back();
          Slot& sl = *s->slots[sid];
          std::lock_guard<std::mutex> slk(sl.m);
          sl.open = true;
          sl.pending = true;  // zero-scored until control scrubs it
          sl.owner = c;
          sl.gen += 1;
          sl.rd = sl.wr = 0;
          gen = sl.gen;
          c->slots.push_back(sid);
          s->granted.push_back(Grant{sid, gen, threshold});
        } else {
          s->st_refused += 1;
        }
      }
      bool dropped;
      if (sid < 0) {
        const char* msg = "no free stream slots";
        send_frame(s, c, ERR, 0, (const uint8_t*)msg,
                   (uint32_t)strlen(msg), &dropped);
      } else {
        send_frame(s, c, OPENED, (uint32_t)sid, nullptr, 0, &dropped);
        if (dropped) {
          // The grant reply could not be queued (outbox saturated): the
          // client will never learn the slot id and can never CLOSE it.
          // Undo the grant — otherwise capacity silently shrinks by one
          // slot per swallowed reply until disconnect.
          std::lock_guard<std::mutex> lk(s->reg_m);
          release_slot_locked(s, sid, c);  // also purges the grant
          for (auto it = c->slots.begin(); it != c->slots.end(); ++it) {
            if (*it == sid) {
              c->slots.erase(it);
              break;
            }
          }
          s->st_refused += 1;
        }
      }
      break;
    }
    case AUDIO: {
      if (h.length % 4 != 0) {
        protocol_error(s, c, "AUDIO payload not float32-aligned");
        return;
      }
      if (h.stream >= (uint32_t)s->num_streams) {
        protocol_error(s, c, "AUDIO for unknown slot");
        return;
      }
      Slot& sl = *s->slots[h.stream];
      bool owned = true;
      long long dropped = 0;
      {
        std::lock_guard<std::mutex> lk(sl.m);
        if (!sl.open || sl.owner != c) {
          owned = false;
        } else {
          size_t n = h.length / 4;
          const float* src = (const float*)payload;
          size_t cap = (size_t)s->buffer_cap;
          // Drop OLDEST on overflow, counted (outside sl.m: lock order
          // everywhere else is reg_m -> sl.m).
          size_t need = sl.wr + n > sl.rd + cap
                            ? (sl.wr + n) - (sl.rd + cap) : 0;
          if (need) {
            sl.rd += need;
            dropped = (long long)need;
          }
          if (n >= cap) {  // giant frame: keep only the newest samples
            src += n - cap;
            n = cap;
            sl.rd = sl.wr;
          }
          size_t w = sl.wr % cap;
          size_t first = n < cap - w ? n : cap - w;
          std::memcpy(sl.ring.data() + w, src, first * sizeof(float));
          if (n > first) {
            std::memcpy(sl.ring.data(), src + first,
                        (n - first) * sizeof(float));
          }
          sl.wr += n;
        }
      }
      if (dropped) {
        std::lock_guard<std::mutex> rk(s->reg_m);
        s->st_dropped_samples += dropped;
      }
      if (!owned) {
        // Match the Python server: audio for an unowned slot is a
        // protocol violation.
        protocol_error(s, c, "AUDIO for unowned slot");
      }
      return;
    }
    case THRESH: {
      float thr = 0.0f;
      if (h.length != 4) {
        protocol_error(s, c, "THRESH payload must be 4 bytes");
        return;
      }
      std::memcpy(&thr, payload, 4);
      if (!std::isfinite(thr)) {
        protocol_error(s, c, "THRESH threshold must be finite");
        return;
      }
      bool owned = false;
      {
        std::lock_guard<std::mutex> lk(s->reg_m);
        if (h.stream < (uint32_t)s->num_streams) {
          Slot& sl = *s->slots[h.stream];
          std::lock_guard<std::mutex> slk(sl.m);
          owned = sl.open && sl.owner == c;
        }
        if (owned) {
          // Last-writer-wins per slot (retunes only apply between
          // ticks, so intermediate values were never observable) —
          // and a THRESH-spamming client cannot grow the queue past
          // num_streams entries.
          bool replaced = false;
          for (auto& e : s->thr_updates) {
            if (e.first == (int)h.stream) {
              e.second = thr;
              replaced = true;
              break;
            }
          }
          if (!replaced) s->thr_updates.emplace_back((int)h.stream, thr);
        }
      }
      if (!owned) {
        // matches the python tier: retuning an unowned slot severs
        // (protocol_error flushes outside reg_m — never hold the
        // registry across a socket send)
        protocol_error(s, c, "THRESH for unowned slot");
        return;
      }
      break;
    }
    case CLOSE: {
      std::lock_guard<std::mutex> lk(s->reg_m);
      if (h.stream < (uint32_t)s->num_streams) {
        release_slot_locked(s, (int)h.stream, c);
        for (size_t i = 0; i < c->slots.size(); ++i) {
          if (c->slots[i] == (int)h.stream) {
            c->slots.erase(c->slots.begin() + i);
            break;
          }
        }
      }
      break;
    }
    default:
      protocol_error(s, c, "unexpected frame type");
  }
}

void drain_input(Server* s, Conn* c) {
  uint8_t tmp[65536];
  for (;;) {
    ssize_t r = ::recv(c->fd, tmp, sizeof(tmp), 0);
    if (r > 0) {
      c->inbuf.insert(c->inbuf.end(), tmp, tmp + r);
      if ((size_t)r < sizeof(tmp)) break;
    } else if (r == 0) {
      c->dead = true;
      break;
    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
      break;
    } else {
      c->dead = true;
      break;
    }
  }
  // Parse complete frames.
  size_t off = 0;
  while (!c->dead && c->inbuf.size() - off >= kHeaderSize) {
    const uint8_t* p = c->inbuf.data() + off;
    uint16_t magic = (uint16_t)(p[0] | (p[1] << 8));
    if (magic != kMagic) {
      protocol_error(s, c, "bad magic");
      break;
    }
    Header h;
    h.type = p[2];
    std::memcpy(&h.stream, p + 4, 4);
    std::memcpy(&h.length, p + 8, 4);
    if (h.length > kMaxPayload) {
      protocol_error(s, c, "oversized frame");
      break;
    }
    if (c->inbuf.size() - off - kHeaderSize < h.length) break;
    handle_frame(s, c, h, p + kHeaderSize);
    off += kHeaderSize + h.length;
  }
  if (off) c->inbuf.erase(c->inbuf.begin(), c->inbuf.begin() + off);
}

void io_loop(Server* s, int widx) {
  Worker& me = s->workers[widx];
  epoll_event evs[128];
  for (;;) {
    int n = epoll_wait(me.epoll_fd, evs, 128, 200);
    if (s->stopping) return;
    std::vector<Conn*> reap;
    for (int i = 0; i < n; ++i) {
      void* ptr = evs[i].data.ptr;
      if (ptr == (void*)&s->listen_fd) {
        // Only worker 0's epoll carries the listen fd; it assigns each
        // accepted connection to a worker round-robin (registering an
        // fd in another thread's live epoll set is kernel-safe).
        for (;;) {
          int fd = accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (fd < 0) {
            // EAGAIN: backlog drained. Anything else (EMFILE/ENFILE,
            // ECONNABORTED): the listen fd stays readable under
            // level-triggered epoll, so a bare break would busy-spin
            // the io thread at 100% CPU on this one-core host. A short
            // sleep bounds the retry rate; already-connected streams
            // keep their cadence.
            if (errno != EAGAIN && errno != EWOULDBLOCK) {
              struct timespec ts = {0, 50 * 1000 * 1000};  // 50 ms
              nanosleep(&ts, nullptr);
            }
            break;
          }
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn* c = new Conn();
          c->fd = fd;
          c->worker = (int)(s->rr.fetch_add(1) % s->workers.size());
          {
            std::lock_guard<std::mutex> lk(s->reg_m);
            s->conns[fd] = c;
            s->st_connections += 1;
          }
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.ptr = c;
          epoll_ctl(s->workers[c->worker].epoll_fd, EPOLL_CTL_ADD, fd,
                    &ev);
        }
      } else if (ptr == (void*)&me.wake_fd) {
        uint64_t junk;
        while (read(me.wake_fd, &junk, 8) == 8) {
        }
        // Router enqueued events: flush every connection THIS worker
        // owns that has output (other workers got their own wake).
        std::vector<Conn*> cs;
        {
          std::lock_guard<std::mutex> lk(s->reg_m);
          cs.reserve(s->conns.size());
          for (auto& kv : s->conns) {
            if (kv.second->worker == widx) cs.push_back(kv.second);
          }
        }
        for (Conn* c : cs) {
          flush_conn(s, c);
          if (c->dead) {
            // Dedup: one epoll batch can surface the same connection
            // from both the wake branch and a socket event; a second
            // close_conn on a freed pointer is use-after-free.
            if (!c->reaped) {
              c->reaped = true;
              reap.push_back(c);
            }
          } else {
            rearm(s, c);
          }
        }
      } else {
        Conn* c = (Conn*)ptr;
        if (evs[i].events & (EPOLLHUP | EPOLLERR)) c->dead = true;
        if (!c->dead && (evs[i].events & EPOLLIN)) drain_input(s, c);
        if (!c->dead && (evs[i].events & EPOLLOUT)) flush_conn(s, c);
        if (c->dead) {
          if (!c->reaped) {
            c->reaped = true;
            reap.push_back(c);
          }
        } else {
          rearm(s, c);
        }
      }
    }
    for (Conn* c : reap) close_conn(s, c);
  }
}

// Row converters for the two assemble output formats. The int16 variant
// quantizes with i = clip(round(x*32768), -32768, 32767) — the inverse
// of the device-side dequant in stream/ring.py (x = i/32768) — so the
// daemon can upload half the bytes per tick over a bandwidth-bound
// host↔device link (16-bit PCM is what capture hardware emits anyway).
inline void cvt_row(float* row, const float* src, size_t n) {
  std::memcpy(row, src, n * sizeof(float));
}
inline void cvt_row(int16_t* row, const float* src, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float v = src[i] * 32768.0f;
    if (!(v == v)) {  // NaN on the wire (any 4 bytes are a valid f32
      row[i] = 0;     // frame): map to 0 — the float->int conversion
      continue;       // would otherwise be UB and diverge from the
    }                 // python twin's convention.
    if (v > 32767.0f) v = 32767.0f;    // +inf clips here
    if (v < -32768.0f) v = -32768.0f;  // -inf clips here
    row[i] = (int16_t)(v >= 0.0f ? v + 0.5f : v - 0.5f);
  }
}
// 8-bit μ-law (μ=255), mid-tread: code = round(sign(x)·ln(1+255|x|)
// /ln(256) · 127) + 128 over x clipped to [-1,1]; code 128 IS exact
// zero (digital silence must survive companding — the scoring path
// peak-normalizes per window and would amplify a mid-riser's DC
// offset to full scale). float64 math end-to-end so the python twin
// serve.quantize_mulaw is bit-exact. NaN -> 128, ±inf -> full scale.
inline void cvt_row(uint8_t* row, const float* src, size_t n) {
  constexpr double kInvLn256 = 0.18033688011112042;  // 1/ln(256)
  for (size_t i = 0; i < n; ++i) {
    double v = (double)src[i];
    if (!(v == v)) v = 0.0;
    if (v > 1.0) v = 1.0;
    if (v < -1.0) v = -1.0;
    double m = std::log1p(255.0 * std::fabs(v)) * kInvLn256;
    double lvl = m * 127.0 + 0.5;  // |m| <= 1 so |level| <= 127
    row[i] = (uint8_t)(v >= 0.0 ? 128.0 + (double)(int)lvl
                                : 128.0 - (double)(int)lvl);
  }
}

// Digital silence per output format: 0 for f32/int16, but μ-law's zero
// is CODE 128 (mid-tread) — a 0x00 fill would decode to ~full-scale
// negative DC on every underrun/closed row.
template <typename T>
inline void silence_fill(T* p, size_t n) {
  std::memset(p, 0, sizeof(T) * n);
}
inline void silence_fill(uint8_t* p, size_t n) {
  std::memset(p, 128, n);
}

template <typename T>
int assemble_impl(Server* s, T* dst) {
  int open_slots = 0;
  size_t cap = (size_t)s->buffer_cap;
  int chunk = s->chunk;
  for (int sid = 0; sid < s->num_streams; ++sid) {
    Slot& sl = *s->slots[sid];
    T* row = dst + (size_t)sid * chunk;
    std::lock_guard<std::mutex> lk(sl.m);
    if (!sl.open || sl.pending) {
      silence_fill(row, chunk);
      if (sl.open) ++open_slots;
      continue;
    }
    ++open_slots;
    size_t avail = sl.wr - sl.rd;
    size_t take = avail < (size_t)chunk ? avail : (size_t)chunk;
    size_t r = sl.rd % cap;
    size_t first = take < cap - r ? take : cap - r;
    cvt_row(row, sl.ring.data() + r, first);
    if (take > first) {
      cvt_row(row + first, sl.ring.data(), take - first);
    }
    if (take < (size_t)chunk) {
      silence_fill(row + take, (size_t)(chunk - take));
    }
    sl.rd += take;
  }
  return open_slots;
}

}  // namespace

extern "C" {

void* cdt_ingest_start(const char* host, int port, int num_streams,
                       int chunk, long buffer_cap, int num_workers,
                       char* errbuf, int errlen) {
  auto* s = new Server();
  s->num_streams = num_streams;
  s->chunk = chunk;
  s->buffer_cap = buffer_cap;
  s->slots.reserve(num_streams);
  for (int i = 0; i < num_streams; ++i) {
    s->slots.push_back(std::make_unique<Slot>());
    s->slots.back()->ring.assign((size_t)buffer_cap, 0.0f);
  }
  for (int i = num_streams - 1; i >= 0; --i) s->free_slots.push_back(i);

  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    set_err(errbuf, errlen, "socket() failed");
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    set_err(errbuf, errlen, "bad host address");
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  if (bind(s->listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(s->listen_fd, 128) != 0 || !set_nonblock(s->listen_fd)) {
    set_err(errbuf, errlen, "bind/listen failed");
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, (sockaddr*)&addr, &alen);
  s->port = ntohs(addr.sin_port);

  int nw = num_workers < 1 ? 1 : (num_workers > 64 ? 64 : num_workers);
  // Size the vector FULLY before any thread starts: worker wake_fd
  // member addresses are epoll sentinels and must never move.
  s->workers = std::vector<Worker>((size_t)nw);
  for (int w = 0; w < nw; ++w) {
    Worker& wk = s->workers[w];
    wk.epoll_fd = epoll_create1(0);
    wk.wake_fd = eventfd(0, EFD_NONBLOCK);
    epoll_event wev{};
    wev.events = EPOLLIN;
    wev.data.ptr = (void*)&wk.wake_fd;
    epoll_ctl(wk.epoll_fd, EPOLL_CTL_ADD, wk.wake_fd, &wev);
  }
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.ptr = (void*)&s->listen_fd;
  epoll_ctl(s->workers[0].epoll_fd, EPOLL_CTL_ADD, s->listen_fd, &ev);
  for (int w = 0; w < nw; ++w) {
    s->workers[w].th = std::thread(io_loop, s, w);
  }
  return s;
}

int cdt_ingest_port(void* h) { return ((Server*)h)->port; }

int cdt_ingest_granted(void* h, int* slots, unsigned* gens,
                       float* thresholds, int cap) {
  auto* s = (Server*)h;
  std::lock_guard<std::mutex> lk(s->reg_m);
  int n = 0;
  for (auto& g : s->granted) {
    if (n >= cap) break;
    slots[n] = g.sid;
    gens[n] = g.gen;
    thresholds[n] = g.threshold;  // NaN = server default
    // Activate: assemble may now pull this slot's audio (the control
    // plane scrubs the device lane before the tick that follows).
    Slot& sl = *s->slots[g.sid];
    std::lock_guard<std::mutex> slk(sl.m);
    if (sl.open && sl.gen == g.gen) sl.pending = false;
    ++n;
  }
  s->granted.erase(s->granted.begin(), s->granted.begin() + n);
  return n;
}

// Drain mid-stream THRESH retunes queued since the last call; the
// control plane applies them to the device lanes (scrub-free) after any
// grants the same tick.
int cdt_ingest_thresh_updates(void* h, int* slots, float* thresholds,
                              int cap) {
  auto* s = (Server*)h;
  std::lock_guard<std::mutex> lk(s->reg_m);
  int n = 0;
  for (auto& [sid, thr] : s->thr_updates) {
    if (n >= cap) break;
    slots[n] = sid;
    thresholds[n] = thr;
    ++n;
  }
  s->thr_updates.erase(s->thr_updates.begin(), s->thr_updates.begin() + n);
  return n;
}

int cdt_ingest_assemble(void* h, float* dst) {
  return assemble_impl((Server*)h, dst);
}

// Eager-tick readiness (serve/server.py tick_policy="eager"), tri-state —
// the C++ twin of the python tier's _readiness() over its slot registry:
//   2: >=1 slot open and EVERY open slot has a full chunk -> tick now;
//   1: SOME open slot has a full chunk but another does not -> a live
//      tenant is being stalled; the liveness deadline applies;
//   0: no open slot has a full chunk (no slots, or all idle/partial) ->
//      nobody is stalled, the eager loop must NOT tick (a zero-fill tick
//      here would inject silence into streams whose audio is merely
//      in flight).
// Pending (granted-but-unactivated) slots count too: the tick that
// follows activates them via cdt_ingest_granted before assembling, so
// their audio is consumed by that same tick.
int cdt_ingest_readiness(void* h) {
  auto* s = (Server*)h;
  int open_slots = 0, ready_slots = 0;
  for (int sid = 0; sid < s->num_streams; ++sid) {
    Slot& sl = *s->slots[sid];
    std::lock_guard<std::mutex> lk(sl.m);
    if (!sl.open) continue;
    ++open_slots;
    if (sl.wr - sl.rd >= (size_t)s->chunk) ++ready_slots;
  }
  if (open_slots == 0 || ready_slots == 0) return 0;
  return ready_slots == open_slots ? 2 : 1;
}

// Boolean view kept for the original twin contract
// (cdt_ingest_ready <-> server._ready()): all open slots ready.
int cdt_ingest_ready(void* h) { return cdt_ingest_readiness(h) == 2; }

// int16 PCM assembly (quantize-on-assemble): same tick semantics, half
// the host→device bytes. Pairs with the in-tick dequant in
// stream/ring.py and the host twin serve.quantize_i16.
int cdt_ingest_assemble_i16(void* h, int16_t* dst) {
  return assemble_impl((Server*)h, dst);
}

// 8-bit μ-law assembly (compand-on-assemble): same tick semantics,
// one quarter of the f32 host→device bytes. Pairs with the in-tick
// μ-law decode in stream/ring.py and the host twin
// serve.quantize_mulaw.
int cdt_ingest_assemble_u8(void* h, uint8_t* dst) {
  return assemble_impl((Server*)h, dst);
}

void cdt_ingest_send_events(void* h, int n, const int* slots,
                            const unsigned* gens, const double* times,
                            const float* confs) {
  auto* s = (Server*)h;
  bool any = false;
  {
    std::lock_guard<std::mutex> lk(s->reg_m);
    for (int i = 0; i < n; ++i) {
      int sid = slots[i];
      if (sid < 0 || sid >= s->num_streams) continue;
      Slot& sl = *s->slots[sid];
      Conn* owner;
      {
        std::lock_guard<std::mutex> slk(sl.m);
        if (!sl.open || sl.gen != gens[i]) {
          s->st_events_dropped += 1;  // released/reused mid-flight
          continue;
        }
        owner = sl.owner;
      }
      // Locale-independent "%.6f": snprintf's decimal separator follows
      // LC_NUMERIC (an embedding host process may setlocale()), which
      // would emit "0,500000" — invalid JSON the Python twin
      // (protocol.encode_event via json.dumps) never produces. Format
      // sign + integer micros manually. Values here are stream times
      // (seconds) and confidences, far inside llround's range.
      auto fmt_f6 = [](char* dst, size_t cap, double v) -> int {
        long long micro = (long long)llround(v * 1e6);
        unsigned long long m =
            micro < 0 ? (unsigned long long)(-micro)
                      : (unsigned long long)micro;
        return std::snprintf(dst, cap, "%s%llu.%06llu",
                             micro < 0 ? "-" : "", m / 1000000ULL,
                             m % 1000000ULL);
      };
      char tbuf[32], cbuf[32];
      fmt_f6(tbuf, sizeof(tbuf), times[i]);
      fmt_f6(cbuf, sizeof(cbuf), (double)confs[i]);
      char body[96];
      int blen = std::snprintf(body, sizeof(body),
                               "{\"time\": %s, \"confidence\": %s}",
                               tbuf, cbuf);
      bool dropped;
      send_frame(s, owner, EVENT, (uint32_t)sid, (const uint8_t*)body,
                 (uint32_t)blen, &dropped);
      if (dropped) s->st_events_dropped += 1;
      else s->st_events += 1;
      any = true;
    }
  }
  if (any) {
    uint64_t one_u = 1;
    for (auto& w : s->workers) {
      ssize_t unused = write(w.wake_fd, &one_u, 8);
      (void)unused;
    }
  }
}

void cdt_ingest_stats(void* h, long long* out, int n) {
  auto* s = (Server*)h;
  std::lock_guard<std::mutex> lk(s->reg_m);
  long long vals[6] = {
      s->st_connections, s->st_refused, s->st_dropped_samples,
      s->st_events, s->st_events_dropped,
      (long long)(s->num_streams - (int)s->free_slots.size()),
  };
  for (int i = 0; i < n && i < 6; ++i) out[i] = vals[i];
}

void cdt_ingest_stop(void* h) {
  auto* s = (Server*)h;
  s->stopping = true;
  uint64_t one_u = 1;
  for (auto& w : s->workers) {
    ssize_t unused = write(w.wake_fd, &one_u, 8);
    (void)unused;
  }
  for (auto& w : s->workers) {
    if (w.th.joinable()) w.th.join();
  }
  {
    std::lock_guard<std::mutex> lk(s->reg_m);
    for (auto& kv : s->conns) {
      ::close(kv.second->fd);
      delete kv.second;
    }
    s->conns.clear();
  }
  ::close(s->listen_fd);
  for (auto& w : s->workers) {
    ::close(w.epoll_fd);
    ::close(w.wake_fd);
  }
  delete s;
}

}  // extern "C"
