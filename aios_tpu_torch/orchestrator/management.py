"""Management console: REST + WebSocket + embedded dashboard on :9090.

Reference parity (agent-core/src/management.rs:43-54 routes, 757+ dashboard):
  GET  /api/status            system summary
  GET  /api/goals             goal list        POST /api/goals  submit
  GET  /api/goals/{id}/tasks  task list
  GET  /api/goals/{id}/messages  conversation thread
  POST /api/chat              chat-style goal submission
  GET  /api/agents            live agents
  GET  /api/health            liveness
  WS   /ws                    event push with subscribe_goal
plus a single-file embedded HTML dashboard at /.

Implemented with aiohttp on a dedicated thread/event loop (the reference
uses axum inside tokio).
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from typing import Optional, Set

from aiohttp import WSMsgType, web

log = logging.getLogger("aios.console")

DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>aiOS-TPU Console</title>
<style>
 :root{--bg:#0d1117;--panel:#161b22;--border:#30363d;--dim:#7d8590;
       --fg:#e6edf3;--accent:#1f6feb;--ok:#238636;--bad:#da3633}
 body{font-family:system-ui,sans-serif;margin:0;background:var(--bg);
      color:var(--fg)}
 header{display:flex;align-items:center;gap:16px;padding:12px 20px;
        background:var(--panel);border-bottom:1px solid var(--border)}
 h1{font-size:16px;margin:0}
 #conn{font-size:11px;padding:2px 10px;border-radius:10px;background:#da363333}
 #conn.live{background:#23863633}
 main{display:grid;grid-template-columns:340px 1fr;gap:16px;padding:16px}
 section{background:var(--panel);border:1px solid var(--border);
         border-radius:8px;padding:12px;margin-bottom:16px}
 h2{font-size:13px;margin:0 0 8px;color:var(--dim);text-transform:uppercase}
 .row{padding:6px;border-bottom:1px solid #21262d;font-size:13px;
      cursor:default}
 .row.sel{background:#1f6feb22}
 .goal-row{cursor:pointer}
 .goal-row:hover{background:#1f6feb11}
 .status{float:right;font-size:11px;padding:1px 8px;border-radius:10px;
         background:#1f6feb33}
 .completed{background:#23863633}.failed{background:#da363333}
 .in_progress{background:#9e6a0333}.awaiting_input{background:#8957e533}
 form{display:flex;gap:8px;margin-top:8px}
 input{flex:1;background:var(--bg);border:1px solid var(--border);
       color:var(--fg);padding:8px;border-radius:6px}
 button{background:var(--ok);color:#fff;border:0;padding:8px 16px;
        border-radius:6px;cursor:pointer}
 #chat{height:200px;overflow-y:auto;font-size:13px}
 #chat p{margin:4px 0}.role{color:var(--dim)}
 #stats,#serving,#healthp{font-size:13px;line-height:1.8}
 .bar{height:6px;border-radius:3px;background:#21262d;margin:2px 0 6px}
 .bar i{display:block;height:100%;border-radius:3px;background:var(--accent)}
 #detail{display:none}
 #detail.open{display:block}
 #thread{max-height:220px;overflow-y:auto;font-size:13px;
         border-top:1px solid var(--border);margin-top:8px;padding-top:8px}
 #thread p{margin:4px 0}
 .task-err{color:#f85149;font-size:12px;display:block}
 .tag{font-size:11px;color:var(--dim);margin-left:6px}
 small{color:var(--dim)}
</style></head><body>
<header><h1>aiOS-TPU — orchestrator console</h1>
 <span id="conn">connecting…</span>
 <small id="uptime"></small></header>
<main>
 <div><!-- left column -->
  <section><h2>Chat / submit goal</h2>
   <div id="chat"></div>
   <form onsubmit="return send(event)">
    <input id="msg" placeholder="Describe a goal..." autocomplete="off">
    <button>Send</button></form>
  </section>
  <section><h2>System</h2><div id="stats">loading…</div></section>
  <section><h2>TPU serving</h2><div id="serving">no models</div></section>
  <section><h2>Service health</h2><div id="healthp">…</div></section>
 </div>
 <div><!-- right column -->
  <section><h2>Goals <small>(click for tasks + conversation)</small></h2>
   <div id="goals"></div></section>
  <section id="detail"><h2 id="dtitle">Goal</h2>
  <button id="cancelbtn" onclick="cancelGoal()">cancel goal</button>
   <div id="dprog" class="bar"><i style="width:0"></i></div>
   <div id="tasks"></div>
   <div id="thread"></div>
  </section>
  <section><h2>Agents</h2><div id="agents"></div></section>
 </div>
</main>
<script>
let selected=null, ws=null;
const $=(id)=>document.getElementById(id);
const esc=(t)=>String(t).replace(/[&<>"]/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[c]));

async function refresh(){
 try{
  const s=await (await fetch('/api/status')).json();
  $('stats').innerHTML=
   `goals: ${s.active_goals} active · tasks pending: ${s.pending_tasks}`+
   `<br>agents: ${s.active_agents} · models: `+
   `${s.loaded_models.map(esc).join(', ')||'none'}`+
   `<br>cpu ${s.cpu_percent.toFixed(0)}%`+
   `<div class="bar"><i style="width:${Math.min(s.cpu_percent,100)}%"></i></div>`+
   `mem ${(s.memory_used_mb/1024).toFixed(1)} / `+
   `${(s.memory_total_mb/1024).toFixed(1)} GB`+
   `<div class="bar"><i style="width:${(100*s.memory_used_mb/s.memory_total_mb).toFixed(0)}%"></i></div>`;
  $('uptime').textContent=`up ${Math.floor(s.uptime_seconds/60)}m`;
 }catch(e){}
 try{
  const gs=await (await fetch('/api/goals')).json();
  $('goals').innerHTML=gs.goals.slice(0,20).map(g=>
   `<div class="row goal-row${g.id===selected?' sel':''}" onclick="openGoal('${g.id}')">`+
   `${esc(g.description.slice(0,80))}`+
   `<span class="tag">${(100*g.progress).toFixed(0)}%</span>`+
   `<span class="status ${g.status}">${g.status}</span></div>`).join('')
   ||'<div class="row">no goals yet</div>';
 }catch(e){}
 try{
  const ag=await (await fetch('/api/agents')).json();
  $('agents').innerHTML=ag.agents.map(a=>
   `<div class="row">${esc(a.agent_id)}<span class="tag">${esc(a.agent_type)}`+
   ` · ${a.tasks_completed} done</span>`+
   `<span class="status ${a.status==='dead'?'failed':''}">${esc(a.status)}</span></div>`)
   .join('')||'<div class="row">none</div>';
 }catch(e){}
 try{
  const sv=await (await fetch('/api/serving')).json();
  const names=Object.keys(sv.models||{});
  $('serving').innerHTML=names.length?names.map(m=>{
   const st=sv.models[m];
   const extra=[];
   if(st.kv_pages_in_use!==undefined)
    extra.push(`pages ${st.kv_pages_in_use}/${st.kv_pages_in_use+st.kv_pages_free}`);
   if(st.prefix_hits!==undefined)
    extra.push(`prefix ${st.prefix_hits}h/${st.prefix_misses}m`);
   if(st.spec_tokens_per_round!==undefined)
    extra.push(`spec ${st.spec_tokens_per_round} tok/rnd`);
   if(st.waiting) extra.push(`<b>${st.waiting} queued</b>`);
   if(st.pool_evictions) extra.push(`${st.pool_evictions} evicted`);
   return `<b>${esc(m)}</b> — slots ${st.active_slots||0}/${st.num_slots||'?'}, `+
    `${st.decode_steps||0} steps<br><small>${extra.join(' · ')}</small>`;
  }).join('<br>'):'no models';
 }catch(e){}
 try{
  const h=await (await fetch('/api/health')).json();
  const svc=h.services||{};
  $('healthp').innerHTML=Object.keys(svc).length?
   Object.entries(svc).map(([n,ok])=>
    `${esc(n)} <span class="status ${ok?'completed':'failed'}">`+
    `${ok?'healthy':'down'}</span><br>`).join(''):
   `orchestrator <span class="status completed">healthy</span>`;
 }catch(e){}
 if(selected) loadDetail(selected);
}

async function openGoal(id){
 selected=id;
 $('detail').classList.add('open');
 if(ws&&ws.readyState===1)
  ws.send(JSON.stringify({action:'subscribe_goal',goal_id:id}));
 await loadDetail(id); refresh();
}

async function cancelGoal(){
 if(!selected)return;
 try{
  const r=await fetch(`/api/goals/${selected}/cancel`,{method:'POST'});
  if(!r.ok){
   const b=await r.json().catch(()=>({}));
   $('dtitle').textContent+=` — cancel failed (${b.error||'already terminal'})`;
  }
 }catch(e){$('dtitle').textContent+=' — cancel failed (console unreachable)';}
 refresh();
}

async function loadDetail(id){
 try{
  const ts=await (await fetch(`/api/goals/${id}/tasks`)).json();
  $('dtitle').textContent=`Goal ${id.slice(0,8)} — ${ts.tasks.length} task(s)`;
  $('tasks').innerHTML=ts.tasks.map(t=>
   `<div class="row">${esc(t.description.slice(0,90))}`+
   `<span class="tag">${esc(t.agent||'unassigned')}</span>`+
   `<span class="status ${t.status}">${t.status}</span>`+
   (t.error?`<span class="task-err">${esc(t.error.slice(0,120))}</span>`:'')+
   `</div>`).join('')||'<div class="row">no tasks yet</div>';
  const ms=await (await fetch(`/api/goals/${id}/messages`)).json();
  $('thread').innerHTML=ms.messages.map(m=>
   `<p><span class="role">${esc(m.role)}:</span> ${esc(m.content)}</p>`)
   .join('')||'<p class="role">no conversation yet</p>';
 }catch(e){}
}

async function send(e){
 e.preventDefault();
 const input=$('msg');
 const text=input.value.trim(); if(!text)return false; input.value='';
 chatAdd('you',text);
 try{
  const r=await (await fetch('/api/chat',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({message:text})})).json();
  chatAdd('aios',r.reply);
  if(r.goal_id) openGoal(r.goal_id);
 }catch(err){chatAdd('aios','(submit failed)');}
 refresh(); return false;
}
function chatAdd(role,text){
 const c=$('chat');
 c.innerHTML+=`<p><span class="role">${esc(role)}:</span> ${esc(text)}</p>`;
 c.scrollTop=c.scrollHeight;
}

function connect(){
 try{
  ws=new WebSocket(`ws://${location.host}/ws`);
  ws.onopen=()=>{$('conn').textContent='live';$('conn').classList.add('live');
   if(selected)ws.send(JSON.stringify({action:'subscribe_goal',goal_id:selected}));};
  ws.onclose=()=>{$('conn').textContent='polling';
   $('conn').classList.remove('live');setTimeout(connect,5000);};
  ws.onmessage=(m)=>{
   try{
    const d=JSON.parse(m.data);
    if(d.goal_id&&d.goal_id===selected)loadDetail(selected);
   }catch(e){}
   refresh();
  };
 }catch(e){}
}
refresh(); setInterval(refresh,3000); connect();
</script></body></html>
"""


class ManagementConsole:
    def __init__(self, orchestrator, host: str = "127.0.0.1", port: int = 9090,
                 serving_stats=None, service_health=None):
        """``orchestrator`` is an OrchestratorService (shared state).

        ``serving_stats`` — optional () -> {model: {counter: float}} feed
        (orchestrator/main.py parses the runtime HealthCheck) behind the
        dashboard's "TPU serving" panel. ``service_health`` — optional
        () -> {service: healthy} snapshot (the HealthChecker's
        consecutive-failure map) behind the health panel."""
        self.orch = orchestrator
        self.serving_stats = serving_stats
        self.service_health = service_health
        self.host = host
        self.port = port
        self._ws_clients: Set[web.WebSocketResponse] = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._runner: Optional[web.AppRunner] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self.bound_port: Optional[int] = None

    # -- handlers -----------------------------------------------------------

    async def _index(self, request):
        return web.Response(text=DASHBOARD_HTML, content_type="text/html")

    async def _status(self, request):
        engine = self.orch.engine
        import psutil

        vm = psutil.virtual_memory()
        # loaded_models is a synchronous gRPC ListModels (5 s timeout when
        # the runtime is down) — keep it off the event loop too
        loop = asyncio.get_running_loop()
        try:
            models = await loop.run_in_executor(
                None, lambda: list(self.orch.loaded_models())
            )
        except Exception:  # noqa: BLE001
            models = []
        return web.json_response(
            {
                "active_goals": len(engine.active_goals()),
                "pending_tasks": len(engine.unblocked_pending_tasks(limit=1000)),
                "active_agents": sum(
                    1 for a in self.orch.router.agents() if a.alive
                ),
                "loaded_models": models,
                "cpu_percent": psutil.cpu_percent(interval=None),
                "memory_used_mb": vm.used / 1e6,
                "memory_total_mb": vm.total / 1e6,
                "uptime_seconds": int(time.time() - self.orch.started_at),
            }
        )

    async def _goals(self, request):
        goals = self.orch.engine.list_goals(limit=100)
        return web.json_response(
            {
                "goals": [
                    {
                        "id": g.id,
                        "description": g.description,
                        "status": g.status,
                        "priority": g.priority,
                        "progress": self.orch.engine.progress(g.id),
                        "created_at": g.created_at,
                    }
                    for g in goals
                ]
            }
        )

    async def _submit_goal(self, request):
        body = await request.json()
        goal = self.orch.engine.submit_goal(
            body.get("description", ""),
            priority=int(body.get("priority", 5)),
            source="console",
        )
        await self._broadcast({"event": "goal_submitted", "goal_id": goal.id})
        return web.json_response({"goal_id": goal.id})

    async def _cancel_goal(self, request):
        goal_id = request.match_info["goal_id"]
        if goal_id not in self.orch.engine.goals:
            # a typo'd id is NOT the same as an already-terminal goal
            return web.json_response(
                {"cancelled": False, "error": "unknown goal"}, status=404
            )
        # same semantics as the CancelGoal RPC: engine cancel + in-flight
        # AI inference abort
        ok = self.orch.cancel_goal_by_id(goal_id)
        if ok:
            await self._broadcast(
                {"event": "goal_cancelled", "goal_id": goal_id}
            )
        return web.json_response(
            {"cancelled": ok}, status=200 if ok else 409
        )

    async def _goal_tasks(self, request):
        goal_id = request.match_info["goal_id"]
        tasks = self.orch.engine.tasks_for_goal(goal_id)
        return web.json_response(
            {
                "tasks": [
                    {
                        "id": t.id,
                        "description": t.description,
                        "status": t.status,
                        "agent": t.assigned_agent,
                        "error": t.error,
                    }
                    for t in tasks
                ]
            }
        )

    async def _goal_messages(self, request):
        goal_id = request.match_info["goal_id"]
        msgs = self.orch.engine.messages_for_goal(goal_id)
        return web.json_response(
            {
                "messages": [
                    {"role": m.role, "content": m.content,
                     "timestamp": m.timestamp}
                    for m in msgs
                ]
            }
        )

    async def _chat(self, request):
        body = await request.json()
        text = body.get("message", "").strip()
        if not text:
            return web.json_response({"error": "empty message"}, status=400)
        goal = self.orch.engine.submit_goal(text, source="chat")
        self.orch.engine.add_message(goal.id, "user", text)
        await self._broadcast({"event": "goal_submitted", "goal_id": goal.id})
        return web.json_response(
            {
                "goal_id": goal.id,
                "reply": f"Goal accepted ({goal.id[:8]}). I'll work on it.",
            }
        )

    async def _agents(self, request):
        return web.json_response(
            {
                "agents": [
                    {
                        "agent_id": a.agent_id,
                        "agent_type": a.agent_type,
                        "status": a.status if a.alive else "dead",
                        "tasks_completed": a.tasks_completed,
                    }
                    for a in self.orch.router.agents()
                ]
            }
        )

    async def _health(self, request):
        out = {"healthy": True, "service": "orchestrator"}
        if self.service_health is not None:
            try:
                out["services"] = dict(self.service_health())
            except Exception:  # noqa: BLE001
                pass
        return web.json_response(out)

    async def _serving(self, request):
        """Per-model TPU serving counters (decode steps, KV pages, prefix
        hits, queue depth) — the operator view the reference's llama-server
        backend could never offer. The feed is a synchronous gRPC call
        (runtime HealthCheck, up to 5 s when the runtime is down), so it
        runs in the executor — blocking the event loop would freeze every
        console route exactly when the operator needs it."""
        models = {}
        if self.serving_stats is not None:
            loop = asyncio.get_running_loop()
            try:
                models = await loop.run_in_executor(
                    None, self.serving_stats
                ) or {}
            except Exception:  # noqa: BLE001
                models = {}
        return web.json_response({"models": models})

    async def _ws(self, request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        self._ws_clients.add(ws)
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    try:
                        data = json.loads(msg.data)
                    except ValueError:
                        continue
                    if data.get("action") == "subscribe_goal":
                        goal_id = data.get("goal_id", "")
                        goal = self.orch.engine.goals.get(goal_id)
                        if goal:
                            await ws.send_json(
                                {
                                    "event": "goal_status",
                                    "goal_id": goal_id,
                                    "status": goal.status,
                                    "progress": self.orch.engine.progress(goal_id),
                                }
                            )
        finally:
            self._ws_clients.discard(ws)
        return ws

    async def _broadcast(self, payload: dict) -> None:
        dead = []
        for ws in self._ws_clients:
            try:
                await ws.send_json(payload)
            except Exception:  # noqa: BLE001
                dead.append(ws)
        for ws in dead:
            self._ws_clients.discard(ws)

    def notify(self, payload: dict) -> None:
        """Thread-safe push to all WS clients."""
        if self._loop is not None:
            asyncio.run_coroutine_threadsafe(self._broadcast(payload), self._loop)

    # -- lifecycle ----------------------------------------------------------

    def _build_app(self) -> web.Application:
        app = web.Application()
        app.router.add_get("/", self._index)
        app.router.add_get("/api/status", self._status)
        app.router.add_get("/api/goals", self._goals)
        app.router.add_post("/api/goals", self._submit_goal)
        app.router.add_post("/api/goals/{goal_id}/cancel", self._cancel_goal)
        app.router.add_get("/api/goals/{goal_id}/tasks", self._goal_tasks)
        app.router.add_get("/api/goals/{goal_id}/messages", self._goal_messages)
        app.router.add_post("/api/chat", self._chat)
        app.router.add_get("/api/agents", self._agents)
        app.router.add_get("/api/health", self._health)
        app.router.add_get("/api/serving", self._serving)
        app.router.add_get("/ws", self._ws)
        return app

    def start(self) -> None:
        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def boot():
                self._runner = web.AppRunner(self._build_app())
                await self._runner.setup()
                site = web.TCPSite(self._runner, self.host, self.port)
                await site.start()
                for s in self._runner.sites:
                    sock = s._server.sockets[0]  # noqa: SLF001
                    self.bound_port = sock.getsockname()[1]
                self._started.set()

            self._loop.run_until_complete(boot())
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, name="console", daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)

    def stop(self) -> None:
        if self._loop is None:
            return

        async def shutdown():
            if self._runner:
                await self._runner.cleanup()

        asyncio.run_coroutine_threadsafe(shutdown(), self._loop).result(timeout=5)
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread:
            self._thread.join(timeout=5)
